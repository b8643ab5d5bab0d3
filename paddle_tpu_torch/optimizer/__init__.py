"""Optimizers of the port (``paddle.optimizer`` counterparts)."""
from .optimizer import Optimizer
from .optimizers import Adam, AdamW

__all__ = ["Optimizer", "Adam", "AdamW"]
