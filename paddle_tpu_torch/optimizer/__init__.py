from . import lr
from .optimizer import Optimizer
from .optimizers import SGD, Adam, AdamW

__all__ = ["SGD", "Adam", "AdamW", "Optimizer", "lr"]
