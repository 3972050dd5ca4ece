from .optimizer import Optimizer
from .optimizers import SGD, AdamW

__all__ = ["SGD", "AdamW", "Optimizer"]
