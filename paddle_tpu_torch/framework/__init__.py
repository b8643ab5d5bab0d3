"""``paddle.framework`` of the port: ``save`` / ``load``
(:mod:`.io`)."""
from .io import load, save

__all__ = ["save", "load"]
