"""Neural-network functional ops, initializers, layers and gradient
clipping of the port (``nn.functional``, ``nn.initializer``,
``nn.Linear`` / ``nn.GELU``, ``nn.ClipGradByGlobalNorm``)."""
from . import clip, functional, initializer
from .clip import ClipGradByGlobalNorm
from .layers import GELU, Linear

__all__ = ["functional", "initializer", "clip", "ClipGradByGlobalNorm",
           "GELU", "Linear"]
