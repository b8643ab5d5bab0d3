"""``paddle.incubate.distributed`` of the port (the MoE layer)."""
from . import models

__all__ = ["models"]
