"""Neural-network functional ops, initializers, layers and gradient
clipping of the port (``nn.functional``, ``nn.initializer``,
``nn.Linear`` / ``nn.GELU``, the clips of ``nn.clip`` and
``nn.utils.clip_grad_norm_`` / ``clip_grad_value_``)."""
from . import clip, functional, initializer, utils
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layers import GELU, Linear

__all__ = ["functional", "initializer", "clip", "utils",
           "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "GELU", "Linear"]
