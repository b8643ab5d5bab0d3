"""``paddle.incubate.distributed.models`` of the port."""
from . import moe

__all__ = ["moe"]
