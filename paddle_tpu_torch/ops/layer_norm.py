"""LayerNorm over the last axis with a hand-written backward (K2a/K2b);
counterpart of ``paddle_tpu/ops/pallas/layer_norm.py``.

:func:`layer_norm` is a ``torch.autograd.Function``.  Its forward saves
the fp32 row ``mean`` and ``rstd``; its backward computes ``dx`` from
them (``rstd * (wg - mean(wg) - xhat * mean(wg * xhat))``), while ``dw``
and ``db`` are torch reductions outside the kernel, as ``_ln_bwd`` leaves
them to XLA.

Numerics: fp32 statistics AND fp32 ``* w + b``; only the result is cast
to x's dtype.  This is NOT ``ops.fused_decode.reference_layer_norm``,
which casts the normalised value back to x's dtype before ``* w + b``
and which the ragged serving step keeps using, as the JAX package's
serving step does.

On CUDA tensors the wrapper launches ``csrc/layer_norm.cu`` (design notes
there) or raises; on CPU tensors it takes :func:`layer_norm_ref`, the
plain version the CPU tests and ``chip_smoke.py`` hold the kernel to.
:func:`route` names the kernel's route for a call: ``"vector"`` (rows of
768, 2048 or 4096 held in registers, 16-byte loads), ``"generic"`` (any
other width up to 8192, or a pointer that is not 16-byte aligned: scalar
loads) or ``"wide"`` (rows wider than 8192, at any alignment: a block of
1024 threads streams each row).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["layer_norm", "layer_norm_ref", "layer_norm_fwd",
           "layer_norm_bwd", "layer_norm_dw_db", "route", "launches"]

# kernel launches by name (CUDA route only)
launches = {"ln_fwd": 0, "ln_bwd_dx": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# csrc/layer_norm.cu's routes (its `ln_route`): the widths of the vector
# instantiations, and the widest row of the generic one (wider rows take the
# wide route)
VECTOR_WIDTHS = (768, 2048, 4096)
GENERIC_MAX_H = 8192


def layer_norm_ref(x, w, b, eps: float = 1e-5):
    """Mirror of the JAX package's ``ops/pallas/layer_norm.py``
    ``reference_layer_norm``: fp32 throughout, the result cast to x's
    dtype.  Differentiable by torch autograd."""
    xf = x.float()
    m = xf.mean(dim=-1, keepdim=True)
    var = (xf - m).square().mean(dim=-1, keepdim=True)
    return (((xf - m) * torch.rsqrt(var + eps)) * w.float()
            + b.float()).to(x.dtype)


def _check(x2d, w, b=None):
    if x2d.device.type != "cuda":
        raise ValueError(f"unsupported device {x2d.device}")
    for name, t in (("weight", w), ("bias", b)):
        if t is None:
            continue
        if t.device != x2d.device:
            raise ValueError(f"{name} is on {t.device}, x on {x2d.device}")
        if t.dim() != 1 or t.shape[0] != x2d.shape[1]:
            raise ValueError(f"{name} must be [{x2d.shape[1]}], got "
                             f"{tuple(t.shape)}")
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
    if b is not None and b.dtype != w.dtype:
        raise TypeError(f"weight {w.dtype} and bias {b.dtype} differ")
    if x2d.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x2d.dtype}")


def route(h: int, tensors) -> str:
    """The kernel's route for rows of ``h`` elements in a call that passes
    ``tensors`` (every x-shaped tensor and w, b): ``"vector"`` where h is
    an instantiated width and every ``data_ptr()`` is 16-byte aligned,
    ``"generic"`` for any other h up to ``GENERIC_MAX_H``, ``"wide"``
    above it.  Raises ValueError where no route takes h (h <= 0)."""
    if h in VECTOR_WIDTHS and all(t.data_ptr() % 16 == 0 for t in tensors):
        return "vector"
    if 0 < h <= GENERIC_MAX_H:
        return "generic"
    if h > GENERIC_MAX_H:
        return "wide"
    raise ValueError(f"hidden size {h}: no LayerNorm route takes it")


def _rc(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def layer_norm_fwd(x2d, w, b, eps: float):
    """K2a on ``x2d [N, H]`` (CUDA, contiguous): ``(y, mean, rstd)`` with
    y in x's dtype and fp32 ``mean``/``rstd`` ``[N]``."""
    _check(x2d, w, b)
    n, h = x2d.shape
    y = torch.empty_like(x2d)
    mean = torch.empty(n, dtype=torch.float32, device=x2d.device)
    rstd = torch.empty_like(mean)
    if n == 0:
        return y, mean, rstd
    w, b = w.contiguous(), b.contiguous()
    route(h, (x2d, w, b, y))
    lib = _build.library("layer_norm")
    with torch.cuda.device(x2d.device):
        rc = lib.ln_forward(x2d.data_ptr(), w.data_ptr(), b.data_ptr(),
                            y.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                            n, h, float(eps), _DTYPE_CODE[x2d.dtype],
                            _DTYPE_CODE[w.dtype],
                            torch.cuda.current_stream().cuda_stream)
    _rc(rc, "layer_norm forward")
    launches["ln_fwd"] += 1
    return y, mean, rstd


def layer_norm_bwd(x2d, w, mean, rstd, g2d):
    """K2b: ``dx [N, H]`` in x's dtype from the saved statistics and the
    output gradient ``g2d`` (same dtype as x)."""
    _check(x2d, w)
    n, h = x2d.shape
    if g2d.dtype != x2d.dtype or g2d.shape != x2d.shape:
        raise ValueError(f"gradient {g2d.dtype} {tuple(g2d.shape)} does not "
                         f"match x {x2d.dtype} {tuple(x2d.shape)}")
    dx = torch.empty_like(x2d)
    if n == 0:
        return dx
    w = w.contiguous()
    route(h, (x2d, w, g2d, dx))
    lib = _build.library("layer_norm")
    with torch.cuda.device(x2d.device):
        rc = lib.ln_backward_dx(x2d.data_ptr(), w.data_ptr(),
                                mean.data_ptr(), rstd.data_ptr(),
                                g2d.data_ptr(), dx.data_ptr(), n, h,
                                _DTYPE_CODE[x2d.dtype], _DTYPE_CODE[w.dtype],
                                torch.cuda.current_stream().cuda_stream)
    _rc(rc, "layer_norm backward")
    launches["ln_bwd_dx"] += 1
    return dx


def layer_norm_dw_db(x2d, mean, rstd, g2d, w_dtype, b_dtype):
    """``(dw, db)``: the backward's cross-row reductions, in torch outside
    the kernel, as ``_ln_bwd`` leaves them to XLA."""
    g32 = g2d.float()
    xhat = (x2d.float() - mean[:, None]) * rstd[:, None]
    return (g32 * xhat).sum(0).to(w_dtype), g32.sum(0).to(b_dtype)


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, eps):
        x2d = x.reshape(-1, x.shape[-1]).contiguous()
        y, mean, rstd = layer_norm_fwd(x2d, w, b, eps)
        ctx.save_for_backward(x2d, w, mean, rstd)
        ctx.b_dtype = b.dtype
        return y.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        x2d, w, mean, rstd = ctx.saved_tensors
        g2d = g.reshape(x2d.shape).to(x2d.dtype).contiguous()
        dx = layer_norm_bwd(x2d, w, mean, rstd, g2d)
        dw, db = layer_norm_dw_db(x2d, mean, rstd, g2d, w.dtype, ctx.b_dtype)
        return dx.reshape(g.shape), dw, db, None


def layer_norm(x, w, b, eps: float = 1e-5):
    """``(x - mean) * rsqrt(var + eps) * w + b`` over the last axis.  CPU
    tensors take the plain version; CUDA tensors launch K2a (and K2b in
    the backward) on the current stream, or raise."""
    if x.device.type == "cpu":
        return layer_norm_ref(x, w, b, eps)
    return _LayerNorm.apply(x, w, b, float(eps))


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ln_forward.argtypes = [p, p, p, p, p, p, i, i, f, i, i, p]
    lib.ln_forward.restype = ctypes.c_int
    lib.ln_backward_dx.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
    lib.ln_backward_dx.restype = ctypes.c_int
    lib.ln_route.argtypes = [i, i]
    lib.ln_route.restype = ctypes.c_int


_build.register("layer_norm", _declare)
