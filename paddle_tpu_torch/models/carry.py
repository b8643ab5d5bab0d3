"""Weight carry-over from a ``paddle_tpu`` model.

The caller turns the JAX model's ``state_dict()`` into plain numpy
arrays (``{name: np.asarray(t._data)}``) on its side; this module never
imports the JAX package.  A model in a ``DataParallel`` or group-sharded
wrapper is unwrapped (``_layers``) first, so the names are the bare
model's.  Names and ``[in, out]`` shapes are the same in
both packages, so the copy needs no transposes.  The JAX package carries
weights before ``amp.decorate`` casts them; a model already decorated
takes them too, each value rounded to its parameter's dtype.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["load_paddle_tpu_state"]


def load_paddle_tpu_state(model: torch.nn.Module,
                          arrays: Mapping[str, np.ndarray]) -> None:
    """Fill ``model``'s parameters from ``arrays``, each cast to its
    parameter's dtype.  Raises unless the names match both ways and every
    shape is equal."""
    while hasattr(model, "_layers"):
        model = model._layers
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(arrays))
    extra = sorted(set(arrays) - set(params))
    if missing or extra:
        raise KeyError(f"state mismatch: missing {missing}, "
                       f"unexpected {extra}")
    for name, p in params.items():
        a = np.asarray(arrays[name])
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(a.shape)} != "
                             f"{tuple(p.shape)}")
        with torch.no_grad():
            p.copy_(torch.tensor(a))
