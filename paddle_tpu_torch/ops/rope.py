"""Rotary position embedding (K5); counterpart of
``paddle_tpu/ops/pallas/rope.py``.

:func:`rope` rotates ``x [B, S, H, D]`` by the position tables ``cos``
and ``sin [S, D]``: ``out = x·cos + rot(x)·sin``, interleaved
(``rot[2i] = −x[2i+1]``, ``rot[2i+1] = x[2i]``, LLaMA's style) or neox
(``rot[:D/2] = −x[D/2:]``, ``rot[D/2:] = x[:D/2]``).  It is a
``torch.autograd.Function`` whose backward is the same kernel with sin
negated by a flag (no ``−sin`` tensor is made): for tables that repeat
each frequency across its rotated pair, the layout the incubate gate
admits, that is the rotation's transpose.  The tables get no gradient.

Unlike the JAX route, which transposes q/k to ``[B*H, S, D]`` for the
TPU kernel and back, the kernel reads ``[B, S, H, D]`` by its strides.
Numerics: fp32 products and sum from x and the tables in their own
dtypes, the result rounded once to x's dtype (the JAX kernel promotes
the tables to fp32 the same way).

On CUDA tensors the wrapper launches ``csrc/rope.cu`` (design notes
there) or raises; on CPU tensors it takes :func:`rope_ref`, the plain
version the CPU tests and ``chip_smoke.py`` hold the kernel to.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["rope", "rope_ref", "rope_fwd", "launches"]

# kernel launches (CUDA route only; forward and backward alike)
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def rope_ref(x, cos, sin, neox: bool):
    """Mirror of the JAX package's ``reference_rope`` on ``[B, S, H, D]``
    with ``[S, D]`` tables, computed in fp32 and cast once to x's dtype,
    as the kernel rounds.  Differentiable by torch autograd."""
    xf = x.float()
    if neox:
        x1, x2 = xf.chunk(2, dim=-1)
        rot = torch.cat([-x2, x1], dim=-1)
    else:
        rot = torch.stack([-xf[..., 1::2], xf[..., 0::2]],
                          dim=-1).reshape(xf.shape)
    c = cos.float()[:, None, :]
    s = sin.float()[:, None, :]
    return (xf * c + rot * s).to(x.dtype)


def _rc(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def rope_fwd(x, cos, sin, neox: bool, sin_sign: float = 1.0):
    """K5 on ``x [B, S, H, D]`` (CUDA; any strides with the last axis
    contiguous) and contiguous ``[S, D]`` tables: a new contiguous
    ``[B, S, H, D]`` tensor in x's dtype.  ``sin_sign=-1`` rotates the
    other way (the backward)."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"x must be [B, S, H, D], got {tuple(x.shape)}")
    b, s, h, d = x.shape
    for name, t in (("cos", cos), ("sin", sin)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if tuple(t.shape) != (s, d):
            raise ValueError(f"{name} must be [{s}, {d}], got "
                             f"{tuple(t.shape)}")
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
    if cos.dtype != sin.dtype:
        raise TypeError(f"cos {cos.dtype} and sin {sin.dtype} differ")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if d % 2 or d > 6144:
        raise ValueError(f"head_dim {d} must be even and at most 6144")
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel's grid (65535)")
    out = torch.empty((b, s, h, d), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if x.stride(-1) != 1:
        x = x.contiguous()
    cos, sin = cos.contiguous(), sin.contiguous()
    lib = _build.library("rope")
    with torch.cuda.device(x.device):
        rc = lib.rope_forward(x.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                              out.data_ptr(), b, s, h, d, x.stride(0),
                              x.stride(1), x.stride(2), int(bool(neox)),
                              float(sin_sign), _DTYPE_CODE[x.dtype],
                              _DTYPE_CODE[cos.dtype],
                              torch.cuda.current_stream().cuda_stream)
    _rc(rc, "rope")
    global launches
    launches += 1
    return out


class _Rope(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cos, sin, neox):
        ctx.save_for_backward(cos, sin)
        ctx.neox = neox
        return rope_fwd(x, cos, sin, neox)

    @staticmethod
    def backward(ctx, g):
        cos, sin = ctx.saved_tensors
        # the tables are position constants: no gradient, as the JAX VJP
        # declares theirs zero
        return rope_fwd(g, cos, sin, ctx.neox, sin_sign=-1.0), None, None, \
            None


def rope(x, cos, sin, neox: bool):
    """Rotary embedding of ``x [B, S, H, D]`` by ``[S, D]`` tables.  CPU
    tensors take the plain version; CUDA tensors launch K5 (again, with
    sin negated, in the backward) on the current stream, or raise."""
    if x.device.type == "cpu":
        return rope_ref(x, cos, sin, neox)
    return _Rope.apply(x, cos, sin, bool(neox))


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f, l = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_int64
    lib.rope_forward.argtypes = [p, p, p, p, i, i, i, i, l, l, l, i, f, i, i,
                                 p]
    lib.rope_forward.restype = ctypes.c_int


_build.register("rope", _declare)
