"""Neural-network functional ops and initializers of the port
(``nn.functional``, ``nn.initializer``)."""
from . import functional, initializer

__all__ = ["functional", "initializer"]
