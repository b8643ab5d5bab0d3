"""Tensor-parallel RNG streams; counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/parallel_layers/random.py``
and of the tracker in ``paddle_tpu/random_state.py`` (ref:
``fleet/meta_parallel/parallel_layers/random.py``).

:class:`RNGStatesTracker` keeps named ``torch.Generator`` streams, the
port's own copy of the JAX package's tracker over its PRNG keys.
:func:`model_parallel_random_seed` seeds the reference's two streams:
``global_seed`` (the same on every model-parallel rank: replicated
weights and dropout on replicated activations) and ``local_seed`` (seed
+ 1024 + the mp rank: dropout on a rank's own heads or sequence chunk).
``rng_state(name)`` is a context manager that yields its stream's
generator: the port's ops take explicit generators (``F.dropout(...,
generator=g)``), so nothing global is swapped.
"""
from __future__ import annotations

import contextlib
import random as _py_random
from typing import Dict, Optional

import torch

__all__ = ["RNGStatesTracker", "get_rng_state_tracker",
           "model_parallel_random_seed", "determinate_seed",
           "MODEL_PARALLEL_RNG"]

MODEL_PARALLEL_RNG = "model_parallel_rng"


def _default_device() -> torch.device:
    """The runtime's card once the process group runs, else the CPU."""
    from ....env import is_initialized
    if is_initialized():
        from ....env import runtime
        return torch.device(runtime().device)
    return torch.device("cpu")


class RNGStatesTracker:
    """Named independent RNG streams (ref: ``RNGStatesTracker``), each a
    ``torch.Generator`` on ``device`` (default: the runtime's card, or
    the CPU before ``init_parallel_env``)."""

    def __init__(self):
        self._states: Dict[str, torch.Generator] = {}
        self._seeds: Dict[str, int] = {}

    def add(self, name: str, seed: int, *, device=None):
        if name in self._states:
            raise ValueError(f"rng state {name!r} already exists")
        dev = torch.device(device) if device is not None \
            else _default_device()
        g = torch.Generator(device=dev)
        g.manual_seed(int(seed))
        self._states[name] = g
        self._seeds[name] = int(seed)

    def reseed_all(self, base_seed: int):
        for i, name in enumerate(sorted(self._states)):
            self._seeds[name] = base_seed + 1000 + i
            self._states[name].manual_seed(self._seeds[name])

    def reset(self):
        self._states.clear()
        self._seeds.clear()

    def get_states_tracker(self) -> Dict[str, torch.Tensor]:
        """Each stream's generator state (``get_state()``)."""
        return {n: g.get_state() for n, g in self._states.items()}

    def set_states_tracker(self, states: Dict[str, torch.Tensor]):
        for n, st in states.items():
            self._states[n].set_state(st)

    def initial_seed(self, name: str) -> int:
        return self._seeds[name]

    @contextlib.contextmanager
    def rng_state(self, name: str = "global_seed"):
        """Yield stream ``name``'s generator (made from a hash of the
        name on first use, as the reference does)."""
        if name not in self._states:
            self.add(name, hash(name) & 0x7FFFFFFF)
        yield self._states[name]

    def generator(self, name: str) -> Optional[torch.Generator]:
        return self._states.get(name)


_rng_tracker = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _rng_tracker


def model_parallel_random_seed(seed: Optional[int] = None, *, device=None):
    """ref: ``model_parallel_random_seed``: ``global_seed`` = ``seed`` on
    every mp rank, ``local_seed`` = ``seed + 1024 + mp rank`` (also under
    ``MODEL_PARALLEL_RNG``).  Returns ``(global_seed, local_seed)``."""
    from ...base.topology import get_hybrid_communicate_group
    hcg = get_hybrid_communicate_group()
    rank = hcg.get_model_parallel_rank() if hcg else 0
    if seed is None:
        seed = _py_random.randint(0, 2 ** 31 - 1)
    global_seed = int(seed)
    local_seed = global_seed + 1024 + rank
    tracker = get_rng_state_tracker()
    tracker.reset()
    tracker.add("global_seed", global_seed, device=device)
    tracker.add("local_seed", local_seed, device=device)
    tracker.add(MODEL_PARALLEL_RNG, local_seed, device=device)
    return global_seed, local_seed


def determinate_seed(name: str = "global_seed") -> int:
    """The seed stream ``name`` was made from (made from a hash of the
    name on first use)."""
    tracker = get_rng_state_tracker()
    if tracker.generator(name) is None:
        tracker.add(name, hash(name) & 0x7FFFFFFF)
    return tracker.initial_seed(name)
