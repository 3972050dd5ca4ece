from . import functional, initializer
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_, clip_grad_value_)
from .layer import Dropout, Embedding, LayerNorm, Linear

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "Dropout", "Embedding", "LayerNorm", "Linear", "clip_grad_norm_",
           "clip_grad_value_", "functional", "initializer"]
