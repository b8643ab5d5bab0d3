"""RMSNorm over the last axis with a hand-written backward (K4a/K4b);
counterpart of ``paddle_tpu/ops/pallas/rms_norm.py``.

:func:`rms_norm` is a ``torch.autograd.Function``.  Its forward saves x
and the fp32 row ``r = rsqrt(mean(x²) + eps)`` (``[N, 1]``, the JAX
kernel's layout); its backward computes ``dx = r·w·g − r³·x·mean(x·w·g)``
with the dx kernel, while ``dw = sum(g·x·r)`` is a torch reduction
outside the kernel, as ``_rms_bwd`` leaves it to XLA.

Numerics: fp32 throughout, the result cast once to x's dtype.

On CUDA tensors the wrapper launches ``csrc/rms_norm.cu`` (design notes
there) or raises; on CPU tensors it takes :func:`rms_norm_ref`, the plain
version the CPU tests and ``chip_smoke.py`` hold the kernel to.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["rms_norm", "rms_norm_ref", "rms_norm_fwd", "rms_norm_bwd",
           "launches"]

# kernel launches by name (CUDA route only)
launches = {"rms_fwd": 0, "rms_bwd_dx": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def rms_norm_ref(x, w, eps: float = 1e-6):
    """Mirror of the JAX package's ``reference_rms_norm``: fp32
    throughout, the result cast to x's dtype.  Differentiable by torch
    autograd."""
    xf = x.float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (xf * r * w.float()).to(x.dtype)


def _check(x2d, w):
    if x2d.device.type != "cuda":
        raise ValueError(f"unsupported device {x2d.device}")
    if x2d.dim() != 2 or not x2d.is_contiguous():
        raise ValueError(f"x must be a contiguous [N, H] tensor, got "
                         f"{tuple(x2d.shape)} with strides {x2d.stride()}")
    if w.device != x2d.device:
        raise ValueError(f"weight is on {w.device}, x on {x2d.device}")
    if w.dim() != 1 or w.shape[0] != x2d.shape[1]:
        raise ValueError(f"weight must be [{x2d.shape[1]}], got "
                         f"{tuple(w.shape)}")
    for name, t in (("x", x2d), ("weight", w)):
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")


def _rc(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def rms_norm_fwd(x2d, w, eps: float):
    """K4a on ``x2d [N, H]`` (CUDA, contiguous): ``(y, r)`` with y in x's
    dtype and the fp32 ``r [N, 1]``."""
    _check(x2d, w)
    n, h = x2d.shape
    y = torch.empty_like(x2d)
    r = torch.empty(n, 1, dtype=torch.float32, device=x2d.device)
    if n == 0:
        return y, r
    lib = _build.library("rms_norm")
    w = w.contiguous()
    with torch.cuda.device(x2d.device):
        rc = lib.rms_forward(x2d.data_ptr(), w.data_ptr(), y.data_ptr(),
                             r.data_ptr(), n, h, float(eps),
                             _DTYPE_CODE[x2d.dtype], _DTYPE_CODE[w.dtype],
                             torch.cuda.current_stream().cuda_stream)
    _rc(rc, "rms_norm forward")
    launches["rms_fwd"] += 1
    return y, r


def rms_norm_bwd(x2d, w, r, g2d):
    """K4b: ``dx [N, H]`` in x's dtype from the saved ``r`` and the output
    gradient ``g2d`` (same dtype and shape as x, contiguous)."""
    _check(x2d, w)
    n, h = x2d.shape
    if g2d.dtype != x2d.dtype or g2d.shape != x2d.shape \
            or not g2d.is_contiguous() or g2d.device != x2d.device:
        raise ValueError(f"gradient {g2d.dtype} {tuple(g2d.shape)} on "
                         f"{g2d.device} does not match x {x2d.dtype} "
                         f"{tuple(x2d.shape)} on {x2d.device}, or is not "
                         "contiguous")
    if r.dtype != torch.float32 or r.numel() != n or r.device != x2d.device:
        raise ValueError(f"r must be fp32 with {n} rows, got {r.dtype} "
                         f"{tuple(r.shape)}")
    dx = torch.empty_like(x2d)
    if n == 0:
        return dx
    lib = _build.library("rms_norm")
    w, r = w.contiguous(), r.contiguous()
    with torch.cuda.device(x2d.device):
        rc = lib.rms_backward_dx(x2d.data_ptr(), w.data_ptr(), r.data_ptr(),
                                 g2d.data_ptr(), dx.data_ptr(), n, h,
                                 _DTYPE_CODE[x2d.dtype], _DTYPE_CODE[w.dtype],
                                 torch.cuda.current_stream().cuda_stream)
    _rc(rc, "rms_norm backward")
    launches["rms_bwd_dx"] += 1
    return dx


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps):
        x2d = x.reshape(-1, x.shape[-1]).contiguous()
        y, r = rms_norm_fwd(x2d, w, eps)
        ctx.save_for_backward(x2d, w, r)
        return y.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        x2d, w, r = ctx.saved_tensors
        g2d = g.reshape(x2d.shape).to(x2d.dtype).contiguous()
        dx = rms_norm_bwd(x2d, w, r, g2d)
        # dw: a cross-row reduction, as ``_rms_bwd`` leaves it to XLA
        dw = (g2d.float() * (x2d.float() * r)).sum(0).to(w.dtype)
        return dx.reshape(g.shape), dw, None


def rms_norm(x, w, eps: float = 1e-6):
    """``x * rsqrt(mean(x², -1) + eps) * w`` over the last axis.  CPU
    tensors take the plain version; CUDA tensors launch K4a (and K4b in
    the backward) on the current stream, or raise."""
    if x.device.type == "cpu":
        return rms_norm_ref(x, w, eps)
    return _RMSNorm.apply(x, w, float(eps))


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rms_forward.argtypes = [p, p, p, p, i, i, f, i, i, p]
    lib.rms_forward.restype = ctypes.c_int
    lib.rms_backward_dx.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.rms_backward_dx.restype = ctypes.c_int


_build.register("rms_norm", _declare)
