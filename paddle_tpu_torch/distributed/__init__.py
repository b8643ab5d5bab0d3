"""``paddle.distributed`` of the port: so far only the pass-management
API of ``distributed.passes``."""
from . import passes

__all__ = ["passes"]
