"""``paddle.incubate.nn`` of the port."""
from . import functional

__all__ = ["functional"]
