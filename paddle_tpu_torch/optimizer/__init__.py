"""Optimizers of the port (``paddle.optimizer`` counterparts)."""
from .optimizer import Optimizer
from .optimizers import SGD, Adam, AdamW

__all__ = ["Optimizer", "SGD", "Adam", "AdamW"]
