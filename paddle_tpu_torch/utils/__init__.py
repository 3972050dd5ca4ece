"""paddle.utils, cut to ``cpp_extension``. Counterpart of
paddle_tpu/utils."""
from . import cpp_extension

__all__ = ["cpp_extension"]
