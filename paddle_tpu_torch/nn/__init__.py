"""Neural-network functional ops of the port (``nn.functional``)."""
from . import functional

__all__ = ["functional"]
