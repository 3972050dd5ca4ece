from .activation import gelu
from .common import embedding, linear
from .norm import layer_norm

__all__ = ["embedding", "gelu", "layer_norm", "linear"]
