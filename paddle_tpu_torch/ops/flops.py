"""The floating-point operations the hand-written kernels do, for
``distributed.auto_parallel.Engine.cost``.

``torch.utils.flop_counter.FlopCounterMode`` counts the aten ops of a
step but cannot see a kernel launched through ``ctypes``.  So a wrapper
that launches one adds the operations its kernel does to every count
:func:`counting` has open, where it launches and nowhere else (on the
CPU the plain versions run aten ops, which the flop counter sees).
K1a-c add theirs (the products over the visible (query, key) pairs: 2
in the forward, 3 in dq with its recomputed logits, 4 in dk / dv); the
other kernels of the training paths move bytes and add none.
"""
from __future__ import annotations

import contextlib
from typing import List

__all__ = ["counting", "active", "add", "attention_pairs"]

_open: List[List[int]] = []


@contextlib.contextmanager
def counting():
    """A count (``count[0]``) of the kernels' operations in the block."""
    count = [0]
    _open.append(count)
    try:
        yield count
    finally:
        _open.remove(count)


def active() -> bool:
    return bool(_open)


def add(n: int) -> None:
    for count in _open:
        count[0] += int(n)


def attention_pairs(sq: int, sk: int, causal: bool, q_offset: int) -> int:
    """The (query, key) pairs a head attends: query ``i`` sees keys
    ``j <= i + q_offset`` under ``causal``, else all ``sk``."""
    if not causal:
        return sq * sk
    return sum(min(sk, max(0, i + q_offset + 1)) for i in range(sq))
