"""Flash attention over ``[B*H, S, D]`` with a hand-written backward
(K1a forward, K1b dq, K1c dk/dv); counterpart of
``paddle_tpu/ops/flash_attention.py``.

The contract is the JAX package's:

* ``q [B*Hq, Sq, D]``, ``k``/``v [B*Hkv, Sk, D]``, ``Hq = Hkv * n_rep``
  (GQA: query row ``b`` reads kv row ``b // n_rep``);
* ``scale`` multiplies the logits; ``causal`` masks key ``j`` for query
  ``i`` unless ``q_offset + i >= j`` (bottom-right alignment: the caller
  passes ``q_offset = Sk - Sq``);
* the forward also yields the fp32 row log-sum-exp ``lse [B*Hq, Sq]``;
  the backward computes ``delta = rowsum(O * dO)`` in fp32, then launches
  the dq kernel, then the dk/dv kernel, which sums a GQA group's
  gradients in fp32 and casts once.

There is no block-multiple gate (the kernel masks ragged tails) and no
GQA gate: both were TPU-only rules of ``ops/pallas/flash_attention.py``.

``causal`` with ``q_offset < 0`` raises ``ValueError`` on every route,
the CPU's included.  Then the first ``-q_offset`` query rows see no key,
and the reference defines no answer for them: its jnp reference gives
such a row a uniform average over all keys, its Pallas kernel 0 where
its loop visits no key block and a uniform average over one block's keys
where it does, so the answer depends on its block size.  The CUDA
kernels would give 0 and the plain version a uniform row; no path of
the port builds the shape (``scaled_dot_product_attention`` sends causal
``Sq > Sk`` to its composition).

On CUDA tensors :func:`flash_attention_bhsd` is a ``torch.autograd.
Function`` over ``csrc/flash_attention.cu`` (design notes there) that
launches or raises; on CPU tensors it takes :func:`reference_attention_bhsd`
(differentiated by torch autograd), the plain version the CPU tests and
``chip_smoke.py`` hold the kernels to.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, flops

__all__ = ["flash_attention_bhsd", "reference_attention_bhsd",
           "flash_attention_fwd", "flash_attention_bwd", "launches"]

# kernel launches by name (CUDA route only)
launches = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128
NEG_INF = -1e30


def reference_attention_bhsd(q, k, v, scale: float, causal: bool,
                             q_offset: int = 0, n_rep: int = 1,
                             return_lse: bool = False):
    """Plain version: fp32 logits, the ``-1e30`` mask, fp32 softmax, the
    output cast to q's dtype (``reference_attention_bhsd`` of the JAX
    package, extended to ``q_offset`` and ``n_rep``).  With
    ``return_lse`` also the fp32 row log-sum-exp of the masked logits."""
    if n_rep > 1:
        k = k.repeat_interleave(n_rep, dim=0)
        v = v.repeat_interleave(n_rep, dim=0)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        qi = torch.arange(sq, device=q.device)[:, None] + q_offset
        kj = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(qi >= kj, s, torch.full((), NEG_INF,
                                                dtype=torch.float32,
                                                device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def _check(q, k, v, n_rep):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dim() != 3:
            raise ValueError(f"{name} must be [B*H, S, D], got "
                             f"{tuple(t.shape)}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q, k, v must be float32 or bfloat16, got "
                        f"{q.dtype}")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if k.shape[0] * n_rep != q.shape[0]:
        raise ValueError(f"q has {q.shape[0]} rows, k {k.shape[0]} x n_rep "
                         f"{n_rep}")
    if q.shape[2] != k.shape[2] or q.shape[2] > _MAX_HEAD_DIM:
        raise ValueError(f"head dims q {q.shape[2]}, k {k.shape[2]}: they "
                         f"must agree and be <= {_MAX_HEAD_DIM}")
    if 0 in q.shape or 0 in k.shape:
        raise ValueError("empty attention input")


def _check_offset(causal, q_offset):
    """Raise where a causal query row would see no key (module
    docstring)."""
    if causal and int(q_offset) < 0:
        raise ValueError(f"causal attention with q_offset {int(q_offset)} "
                         "< 0: the first query rows see no key, and the "
                         "reference defines no answer for them")


def _rc(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def _stream():
    return torch.cuda.current_stream().cuda_stream


def flash_attention_fwd(q, k, v, scale: float, causal: bool,
                        q_offset: int = 0, n_rep: int = 1, *,
                        out_fp32: bool = False):
    """K1a on CUDA tensors: ``(out, lse)`` with out in q's dtype (in fp32,
    unrounded, with ``out_fp32``: bf16 inputs take the kernel's dtype code
    2; a ring merges the outputs of its chunks) and fp32 ``lse [B*Hq,
    Sq]``."""
    _check_offset(causal, q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _check(q, k, v, n_rep)
    bh, sq, d = q.shape
    sk = k.shape[1]
    code = _DTYPE_CODE[q.dtype]
    if out_fp32 and q.dtype == torch.bfloat16:
        code = 2
    out = torch.empty(q.shape, dtype=torch.float32 if out_fp32 else q.dtype,
                      device=q.device)
    lse = torch.empty(bh, sq, dtype=torch.float32, device=q.device)
    lib = _build.library("flash_attention")
    with torch.cuda.device(q.device):
        rc = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           out.data_ptr(), lse.data_ptr(), bh, sq, sk, d,
                           int(n_rep), int(bool(causal)), int(q_offset),
                           float(scale), code, _stream())
    _rc(rc, "flash attention forward")
    launches["flash_fwd"] += 1
    if flops.active():
        flops.add(4 * bh * d * flops.attention_pairs(sq, sk, causal,
                                                     q_offset))
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, dout, scale: float,
                        causal: bool, q_offset: int = 0, n_rep: int = 1, *,
                        grads_fp32: bool = False):
    """K1b then K1c on CUDA tensors: ``(dq, dk, dv)`` from the forward's
    ``out`` and ``lse`` and the output gradient ``dout``.  bf16 runs the
    tensor-core kernels, float32 the CUDA-core ones.  ``grads_fp32``:
    the gradients in fp32, unrounded (bf16 inputs: the kernels' dtype
    code 2; a ring sums them over chunks)."""
    _check_offset(causal, q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _check(q, k, v, n_rep)
    dout = dout.to(q.dtype).contiguous()
    if dout.shape != q.shape or out.shape != q.shape:
        raise ValueError("out and dout must have q's shape")
    bh, sq, d = q.shape
    bhkv, sk, _ = k.shape
    delta = (out.float() * dout.float()).sum(-1)            # [BHq, Sq]
    lse = lse.contiguous()
    code = _DTYPE_CODE[q.dtype]
    gdt = q.dtype
    if grads_fp32:
        gdt = torch.float32
        code = 2 if q.dtype == torch.bfloat16 else code
    dq = torch.empty(q.shape, dtype=gdt, device=q.device)
    dk = torch.empty(k.shape, dtype=gdt, device=k.device)
    dv = torch.empty(v.shape, dtype=gdt, device=v.device)
    lib = _build.library("flash_attention")
    args = (sq, sk, d, int(n_rep), int(bool(causal)), int(q_offset),
            float(scale), code)
    with torch.cuda.device(q.device):
        rc = lib.flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              dout.data_ptr(), lse.data_ptr(),
                              delta.data_ptr(), dq.data_ptr(), bh, *args,
                              _stream())
        _rc(rc, "flash attention dq")
        launches["flash_bwd_dq"] += 1
        rc = lib.flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               dout.data_ptr(), lse.data_ptr(),
                               delta.data_ptr(), dk.data_ptr(),
                               dv.data_ptr(), bhkv, *args, _stream())
        _rc(rc, "flash attention dk/dv")
        launches["flash_bwd_dkv"] += 1
    if flops.active():
        flops.add((6 + 8) * bh * d * flops.attention_pairs(sq, sk, causal,
                                                           q_offset))
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, causal, q_offset, n_rep):
        out, lse = flash_attention_fwd(q, k, v, scale, causal, q_offset,
                                       n_rep)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (scale, causal, q_offset, n_rep)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None


# the reference's Pallas block sizes (``paddle_tpu/ops/flash_attention.py``)
DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128


def flash_attention_bhsd(q, k, v, scale: float, causal: bool,
                         block_q: int = DEFAULT_BLOCK_Q,
                         block_k: int = DEFAULT_BLOCK_K,
                         interpret: bool = False,
                         q_offset: int = 0, n_rep: int = 1):
    """Attention over ``[B*H, S, D]`` (contract in the module docstring).
    CPU tensors take the plain version; CUDA tensors launch the kernels
    on the current stream, or raise.  ``causal`` with ``q_offset < 0``
    raises on both (module docstring).  ``block_q``, ``block_k`` and
    ``interpret`` sit where the reference has them: ``interpret`` changes
    nothing (the plain version is the CPU route), and block sizes other
    than the reference's defaults raise ``NotImplementedError`` (the
    kernels pick their own tiles)."""
    if (block_q, block_k) != (DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K):
        raise NotImplementedError(
            f"block sizes ({block_q}, {block_k}): the CUDA kernels tile "
            f"by themselves; pass the defaults ({DEFAULT_BLOCK_Q}, "
            f"{DEFAULT_BLOCK_K})")
    _check_offset(causal, q_offset)
    if q.device.type == "cpu":
        return reference_attention_bhsd(q, k, v, scale, causal, q_offset,
                                        n_rep)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _FlashAttention.apply(q, k, v, float(scale), bool(causal),
                                 int(q_offset), int(n_rep))


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    shape = [i, i, i, i, i, i, i, f, i, p]   # bh, sq, sk, d, n_rep, causal,
    #                                          q_offset, scale, dtype, stream
    lib.flash_fwd.argtypes = [p, p, p, p, p] + shape
    lib.flash_fwd.restype = ctypes.c_int
    lib.flash_bwd_dq.argtypes = [p, p, p, p, p, p, p] + shape
    lib.flash_bwd_dq.restype = ctypes.c_int
    lib.flash_bwd_dkv.argtypes = [p, p, p, p, p, p, p, p] + shape
    lib.flash_bwd_dkv.restype = ctypes.c_int


_build.register("flash_attention", _declare)
