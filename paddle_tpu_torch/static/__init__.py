"""``paddle.static`` of the port: the captured ``Program`` IR
(``capture``) and the program-pass pipeline (``passes``).  The
static-graph API around it (``program_guard``, ``data``, ``Executor``,
``save_inference_model``) is not ported yet."""
from . import passes
from .capture import Program, capture_ops

__all__ = ["Program", "capture_ops", "passes"]
