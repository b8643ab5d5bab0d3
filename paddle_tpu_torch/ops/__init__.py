"""Operators of the port.  Importing this package builds nothing and
needs neither ``nvcc`` nor a GPU: a kernel is compiled at its first
CUDA call (see ``_build``)."""
from . import fused_decode, paged_attention, ragged_paged_attention

__all__ = ["fused_decode", "paged_attention", "ragged_paged_attention"]
