from .optimizer import Optimizer
from .optimizers import AdamW

__all__ = ["AdamW", "Optimizer"]
