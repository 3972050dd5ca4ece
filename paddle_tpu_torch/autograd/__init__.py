"""paddle.autograd, cut to PyLayer (PyTorch's autograd is the tape).
Counterpart of paddle_tpu/autograd."""
from .py_layer import PyLayer, PyLayerContext, once_differentiable

__all__ = ["PyLayer", "PyLayerContext", "once_differentiable"]
