"""Fused AdamW update, in place on a parameter's flat storage (K3);
counterpart of ``paddle_tpu/ops/pallas/fused_adamw.py``.

:func:`fused_adamw_update_` updates ``p``, ``m`` and ``v`` (and the bf16
copy ``p_low`` of an fp32 master ``p``, when given) in one pass.  ``lr``,
``b1p`` and ``b2p`` are device scalars (one-element fp32 tensors): the
optimizer keeps them on the card and never reads them back.  ``b1p`` and
``b2p`` are the bias-correction powers already advanced for this step,
as ``Adam._adam_update`` passes them.

On CUDA tensors the wrapper launches ``csrc/fused_adamw.cu`` (design
notes there) or raises; on CPU tensors it takes
:func:`fused_adamw_update_ref_`, the unfused sequence of
``paddle_tpu/optimizer/optimizers.py`` (``Adam._adam_update``) in torch,
which the CPU tests and ``chip_smoke.py`` hold the kernel to.  Unlike the
JAX function, which returns new arrays, both update in place.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["fused_adamw_update_", "fused_adamw_update_ref_", "launches"]

# kernel launches (CUDA route only)
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def fused_adamw_update_ref_(p, g, m, v, lr, b1p, b2p, b1: float, b2: float,
                            eps: float, wd: float = 0.0, p_low=None):
    """The unfused sequence, every step rounded in fp32 on its own:
    ``m = b1*m + (1-b1)*g``, ``v = b2*v + (1-b2)*g²``, bias correction by
    ``1 - b1p`` / ``1 - b2p``, the decoupled decay ``p * (1 - lr*wd)``
    when ``wd`` is not 0, then ``p - lr*m_hat / (sqrt(v_hat) + eps)``."""
    g32 = g.float()
    m.copy_(m * b1 + g32 * (1.0 - b1))
    v.copy_(v * b2 + (g32 * g32) * (1.0 - b2))
    m_hat = m / (1 - b1p)
    v_hat = v / (1 - b2p)
    p32 = p.float()
    if wd:
        p32 = p32 * (1 - lr * wd)
    p32 = p32 - (lr * m_hat) / (torch.sqrt(v_hat) + eps)
    p.copy_(p32)
    if p_low is not None:
        p_low.copy_(p32)


def _check(p, g, m, v, lr, b1p, b2p, p_low):
    dev = p.device
    named = {"p": p, "g": g, "m": m, "v": v, "lr": lr, "b1p": b1p,
             "b2p": b2p}
    if p_low is not None:
        named["p_low"] = p_low
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, p on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("m", "v", "lr", "b1p", "b2p"):
        if named[name].dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got "
                            f"{named[name].dtype}")
    for name in ("lr", "b1p", "b2p"):
        if named[name].numel() != 1:
            raise ValueError(f"{name} must hold one element")
    if p.dtype not in _DTYPE_CODE or g.dtype not in _DTYPE_CODE:
        raise TypeError(f"p and g must be float32 or bfloat16, got "
                        f"{p.dtype} and {g.dtype}")
    for name in ("g", "m", "v"):
        if named[name].numel() != p.numel():
            raise ValueError(f"{name} has {named[name].numel()} elements, "
                             f"p {p.numel()}")
    if p_low is not None:
        if p_low.dtype != torch.bfloat16 or p.dtype != torch.float32:
            raise TypeError("p_low is the bf16 copy of an fp32 master p")
        if p_low.numel() != p.numel():
            raise ValueError("p_low and p differ in size")


def fused_adamw_update_(p, g, m, v, lr, b1p, b2p, b1: float, b2: float,
                        eps: float, wd: float = 0.0, p_low=None):
    """AdamW on ``p`` (fp32 or bf16) with gradient ``g`` (fp32 or bf16)
    and fp32 moments ``m``/``v``, in place.  CPU tensors take the plain
    version; CUDA tensors launch the kernel on the current stream, or
    raise."""
    if p.device.type == "cpu":
        return fused_adamw_update_ref_(p, g, m, v, lr, b1p, b2p, b1, b2,
                                       eps, wd, p_low)
    if p.device.type != "cuda":
        raise ValueError(f"unsupported device {p.device}")
    _check(p, g, m, v, lr, b1p, b2p, p_low)
    if p.numel() == 0:
        return None
    lib = _build.library("fused_adamw")
    with torch.cuda.device(p.device):
        rc = lib.adamw_update(
            p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
            p_low.data_ptr() if p_low is not None else None,
            lr.data_ptr(), b1p.data_ptr(), b2p.data_ptr(), p.numel(),
            float(b1), float(b2), float(1.0 - b1), float(1.0 - b2),
            float(eps), float(wd), _DTYPE_CODE[p.dtype],
            _DTYPE_CODE[g.dtype], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_adamw kernel launch failed: CUDA error "
                           f"{rc}")
    global launches
    launches += 1
    return None


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.adamw_update.argtypes = [p, p, p, p, p, p, p, p, ctypes.c_longlong,
                                 f, f, f, f, f, f, i, i, p]
    lib.adamw_update.restype = ctypes.c_int


_build.register("fused_adamw", _declare)
