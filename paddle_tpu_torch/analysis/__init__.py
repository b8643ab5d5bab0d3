"""Analysis of the port: ``pass_check``, the replay-equivalence verifier
of the program passes."""
from . import pass_check

__all__ = ["pass_check"]
