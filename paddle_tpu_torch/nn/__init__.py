from . import functional, initializer
from .layer import Dropout, Embedding, LayerNorm, Linear

__all__ = ["Dropout", "Embedding", "LayerNorm", "Linear", "functional",
           "initializer"]
