"""Softmax cross-entropy over the last axis with a hand-written backward
(K8a/K8b); counterpart of ``paddle_tpu/ops/pallas/softmax_ce.py``.

:func:`softmax_ce` is a ``torch.autograd.Function``: per row of
``logits2d [N, V]``, ``loss = logsumexp(x) - x[label]``, 0 where the
label is ``ignore_index``.  Its forward saves the fp32 row ``lse``; its
backward computes ``dx = (exp(x - lse) - onehot(label)) * g`` from it,
without materialising the softmax, 0 on ignored rows.  A label outside
``[0, V)`` that is not ``ignore_index`` picks no column, as the Pallas
kernel's one-hot picks none: its loss is the lse and its dx the softmax
times g.  (The JAX package's ``reference_softmax_ce`` gathers there
instead, which is out of bounds; :func:`reference_softmax_ce` follows
the kernel.)

On CUDA tensors the wrapper launches ``csrc/softmax_ce.cu`` (design notes
there) or raises; on CPU tensors it takes :func:`reference_softmax_ce`,
the plain version the CPU tests and ``chip_smoke.py`` hold the kernel to.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["softmax_ce", "reference_softmax_ce", "softmax_ce_fwd",
           "softmax_ce_bwd", "launches"]

# kernel launches by name (CUDA route only)
launches = {"ce_fwd": 0, "ce_bwd": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INT32_MAX = 2**31 - 1


def reference_softmax_ce(logits2d, labels, ignore_index: int = -100):
    """Mirror of the JAX package's ``reference_softmax_ce``: the fp32
    ``logsumexp`` minus the logit picked by ``gather`` at the clamped
    label, 0 where the label is ignored; a label outside ``[0, V)``
    picks 0, as the kernels do.  Per-row fp32 loss ``[N]``,
    differentiable by torch autograd."""
    x = logits2d.float()
    v = x.shape[-1]
    lse = torch.logsumexp(x, dim=-1)
    lab = labels.long()
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    picked = torch.gather(x, -1, lab.clamp(0, v - 1)[:, None])[:, 0]
    picked = torch.where((lab >= 0) & (lab < v), picked, zero)
    return torch.where(lab != ignore_index, lse - picked, zero)


def _check(x2d, lab):
    if x2d.device.type != "cuda":
        raise ValueError(f"unsupported device {x2d.device}")
    if x2d.dtype not in _DTYPE_CODE:
        raise TypeError(f"logits must be float32 or bfloat16, got "
                        f"{x2d.dtype}")
    if x2d.dim() != 2 or not x2d.is_contiguous():
        raise ValueError(f"logits must be a contiguous [N, V], got "
                         f"{tuple(x2d.shape)}")
    n, v = x2d.shape
    if n > _INT32_MAX or v > _INT32_MAX:
        raise ValueError(f"[{n}, {v}] exceeds the kernel's int32 sizes")
    if lab.device != x2d.device or lab.dtype != torch.int32 \
            or tuple(lab.shape) != (n,) or not lab.is_contiguous():
        raise ValueError(f"labels must be a contiguous int32 [{n}] on "
                         f"{x2d.device}, got {lab.dtype} "
                         f"{tuple(lab.shape)} on {lab.device}")


def _rc(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def softmax_ce_fwd(x2d, lab, ignore_index: int = -100):
    """K8a on ``x2d [N, V]`` (CUDA, contiguous) and int32 ``lab [N]``:
    ``(loss, lse)``, fp32 ``[N]`` each (0 and 0 on ignored rows)."""
    _check(x2d, lab)
    n, v = x2d.shape
    loss = torch.empty(n, dtype=torch.float32, device=x2d.device)
    lse = torch.empty_like(loss)
    if n == 0:
        return loss, lse
    lib = _build.library("softmax_ce")
    with torch.cuda.device(x2d.device):
        rc = lib.softmax_ce_forward(
            x2d.data_ptr(), lab.data_ptr(), loss.data_ptr(), lse.data_ptr(),
            n, v, int(ignore_index), _DTYPE_CODE[x2d.dtype],
            torch.cuda.current_stream().cuda_stream)
    _rc(rc, "softmax_ce forward")
    launches["ce_fwd"] += 1
    return loss, lse


def softmax_ce_bwd(x2d, lab, lse, g, ignore_index: int = -100):
    """K8b: ``dx [N, V]`` in x's dtype from the saved ``lse`` and the
    per-row fp32 upstream gradient ``g [N]``."""
    _check(x2d, lab)
    n, v = x2d.shape
    for name, t in (("lse", lse), ("g", g)):
        if t.dtype != torch.float32 or tuple(t.shape) != (n,) \
                or t.device != x2d.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous fp32 [{n}] on "
                             f"{x2d.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    dx = torch.empty_like(x2d)
    if n == 0:
        return dx
    lib = _build.library("softmax_ce")
    with torch.cuda.device(x2d.device):
        rc = lib.softmax_ce_backward(
            x2d.data_ptr(), lab.data_ptr(), lse.data_ptr(), g.data_ptr(),
            dx.data_ptr(), n, v, int(ignore_index), _DTYPE_CODE[x2d.dtype],
            torch.cuda.current_stream().cuda_stream)
    _rc(rc, "softmax_ce backward")
    launches["ce_bwd"] += 1
    return dx


class _SoftmaxCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits2d, labels, ignore_index):
        x = logits2d.contiguous()
        lab = labels.to(torch.int32).contiguous()
        loss, lse = softmax_ce_fwd(x, lab, ignore_index)
        ctx.save_for_backward(x, lab, lse)
        ctx.ignore_index = ignore_index
        return loss

    @staticmethod
    def backward(ctx, g):
        x, lab, lse = ctx.saved_tensors
        dx = softmax_ce_bwd(x, lab, lse, g.float().contiguous(),
                            ctx.ignore_index)
        return dx, None, None


def softmax_ce(logits2d, labels, ignore_index: int = -100):
    """Per-row fp32 loss ``[N]`` of ``logits2d [N, V]`` (fp32 or bf16)
    and integer ``labels [N]``.  CPU tensors take the plain version; CUDA
    tensors launch K8a (and K8b in the backward) on the current stream,
    or raise."""
    if logits2d.device.type == "cpu":
        return reference_softmax_ce(logits2d, labels, ignore_index)
    return _SoftmaxCE.apply(logits2d, labels, int(ignore_index))


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.softmax_ce_forward.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.softmax_ce_forward.restype = ctypes.c_int
    lib.softmax_ce_backward.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.softmax_ce_backward.restype = ctypes.c_int


_build.register("softmax_ce", _declare)
