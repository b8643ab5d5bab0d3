"""``paddle.incubate`` of the port (the fused ops the LLaMA model calls)."""
from . import nn

__all__ = ["nn"]
