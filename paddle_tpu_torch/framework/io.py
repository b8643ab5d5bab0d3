"""``paddle.save`` / ``paddle.load``; counterpart of
``paddle_tpu/framework/io.py`` (ref: ``python/paddle/framework/io.py``).

A pickle of the object with every tensor replaced by a
:class:`_TensorPayload` (its array, ``is_param``, ``name`` and
``stop_gradient``: the JAX package's payload), so one file format serves
both packages:

* ``save`` stores a tensor's values as a numpy array on the host.  A
  bf16 tensor has no numpy dtype, so its raw 16-bit words are stored
  (``uint16``) with the tag ``dtype = "bfloat16"``;
* ``load`` reads the port's files and the JAX package's: its unpickler
  maps ``paddle_tpu.framework.io._TensorPayload`` to this module's class
  and imports nothing of ``paddle_tpu``.  A JAX bf16 array pickles with
  ``ml_dtypes``' dtype; where ``ml_dtypes`` is missing such a file
  raises an ``ImportError`` that names it.

Tensors load on the CPU as ``torch.Tensor`` (a parameter as
``torch.nn.Parameter``), or as numpy arrays with ``return_numpy=True``
(a bf16 tensor as its ``uint16`` words, as Paddle returns bf16).
"""
from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np
import torch

__all__ = ["save", "load"]

_BF16 = "bfloat16"
# the JAX package's payload class, read as this module's
_JAX_PAYLOAD = ("paddle_tpu.framework.io", "_TensorPayload")


class _TensorPayload:
    """Pickle-stable wrapper carrying (array, is_param, name,
    stop_gradient); ``dtype`` tags a bf16 array stored as its words."""

    def __init__(self, t: torch.Tensor):
        data = t.detach().cpu().contiguous()
        self.dtype = None
        if data.dtype == torch.bfloat16:
            data = data.view(torch.int16)
            self.dtype = _BF16
        self.array = data.numpy().copy()
        if self.dtype == _BF16:
            self.array = self.array.view(np.uint16)
        self.is_param = isinstance(t, torch.nn.Parameter)
        self.name = getattr(t, "name", None)       # torch's: None
        self.stop_gradient = not t.requires_grad

    def numpy(self) -> np.ndarray:
        return self.array

    def tensor(self) -> torch.Tensor:
        a = self.array
        if getattr(self, "dtype", None) == _BF16 or str(a.dtype) == _BF16:
            # the port's uint16 words, or a JAX ml_dtypes bfloat16 array
            words = np.ascontiguousarray(a).view(np.int16)
            return torch.from_numpy(words.copy()).view(torch.bfloat16)
        return torch.from_numpy(np.array(a, copy=True))

    def restore(self) -> torch.Tensor:
        """The tensor (a parameter as ``nn.Parameter``); torch tensors
        carry no name, so ``name`` stays in the payload."""
        t = self.tensor()
        if self.is_param:
            return torch.nn.Parameter(t, requires_grad=not self.stop_gradient)
        return t.requires_grad_(not self.stop_gradient
                                and t.is_floating_point())


class _Unpickler(pickle.Unpickler):
    """Maps the JAX package's payload class to the port's; names
    ``ml_dtypes`` when a JAX bf16 array needs it and it is missing."""

    def find_class(self, module, name):
        if (module, name) == _JAX_PAYLOAD:
            return _TensorPayload
        if module.split(".")[0] == "ml_dtypes":
            try:
                return super().find_class(module, name)
            except ImportError as e:
                raise ImportError(
                    "this file holds a bfloat16 array saved by the JAX "
                    "package (paddle_tpu.save); unpickling it needs the "
                    "ml_dtypes package, which is not installed") from e
        return super().find_class(module, name)


def _pack(obj):
    if isinstance(obj, torch.Tensor):
        return _TensorPayload(obj)
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack(v) for v in obj)
    return obj


def _unpack(obj, return_numpy=False):
    if isinstance(obj, _TensorPayload):
        return obj.numpy() if return_numpy else obj.restore()
    if isinstance(obj, dict):
        return {k: _unpack(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unpack(v, return_numpy) for v in obj)
    return obj


def save(obj: Any, path, protocol: int = 4, **configs):
    """paddle.save: ``obj`` (tensors inside dicts, lists and tuples) to
    ``path`` (a file name or a writable file object).  ``configs`` raise
    ``NotImplementedError``."""
    if configs:
        raise NotImplementedError(f"paddle.save configs {sorted(configs)}")
    if hasattr(path, "write"):
        pickle.dump(_pack(obj), path, protocol=protocol)
        return
    path = str(path)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_pack(obj), f, protocol=protocol)


def load(path, **configs) -> Any:
    """paddle.load: what :func:`save` (or the JAX package's
    ``paddle.save``) wrote.  ``return_numpy=True`` gives numpy arrays;
    other ``configs`` raise ``NotImplementedError``."""
    return_numpy = configs.pop("return_numpy", False)
    if configs:
        raise NotImplementedError(f"paddle.load configs {sorted(configs)}")
    if hasattr(path, "read"):
        return _unpack(_Unpickler(path).load(), return_numpy)
    with open(str(path), "rb") as f:
        return _unpack(_Unpickler(f).load(), return_numpy)
