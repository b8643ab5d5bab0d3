"""``paddle.incubate`` of the port (the fused ops the LLaMA model calls,
and ``distributed.models.moe``)."""
from . import distributed, nn

__all__ = ["distributed", "nn"]
