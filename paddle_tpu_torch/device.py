"""Device selection and seeding.

Every entry point of the port takes ``device=None``, which means the
CUDA card.  A caller who wants the CPU says so (``device="cpu"``, as
the tests do); without a card and without that request the entry point
raises instead of carrying on quietly on the CPU.
"""
from __future__ import annotations

import torch

__all__ = ["default_device", "generator", "seed"]


def default_device(device=None) -> torch.device:
    """Resolve ``device`` (``None`` -> the current CUDA card).  Raises
    when CUDA is asked for, explicitly or by default, and no card is
    present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def generator(value: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``value``."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(value))
    return g


def seed(value: int) -> None:
    """Seed torch's global generators (CPU and every CUDA device) —
    the counterpart of ``paddle.seed``.  The port's own entry points
    take explicit generators and do not read these."""
    torch.manual_seed(int(value))
