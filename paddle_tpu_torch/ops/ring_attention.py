"""Ring attention, the context-parallel (cp) attention; counterpart of
``paddle_tpu/ops/ring_attention.py``.

The sequence is split over a group of ``n`` ranks: rank ``r`` holds the
rows at global positions ``[r * S_local, (r + 1) * S_local)`` of q, k
and v (``[B*H, S_local, D]``).  Each rank keeps its q and passes its k/v
chunk around the ring (``batch_isend_irecv`` to rank + 1 and from rank
- 1 of the group, started before the step's compute so the transfer
hides under it).  At step ``i`` rank ``r`` holds the chunk of rank ``(r
- i) mod n`` and runs one flash call against it:

* a chunk past the rank's own (causal) is masked and launches nothing;
* the rank's own chunk is causal with ``q_offset = 0`` (the diagonal);
* an earlier chunk is not causal (every key visible).

Each call's ``(out, lse)`` is merged into the running result by the
log-sum-exp weights, with the reference's ``NEG_INF = -1e30`` guards;
the calls' outputs come out in fp32 (the bf16 kernel's fp32-output
mode), the running output is kept in fp32 and cast to q's dtype once at
the end (the reference rounds each call's output and merges in q's
dtype).  The output feeds the backward's ``delta = rowsum(O dO)``, whose
difference ``dP - delta`` cancels, so one rounding of it (as one call
over the whole sequence makes) keeps the ring's gradients near one
call's; with each chunk's output rounded first they drifted apart with
depth (``PERF.md``, phase 20).  The backward runs a second ring:
the flash backward (K1b, K1c) of each unmasked pair, fed the rank's
final output and its **global** lse, so ``exp(s - lse)`` is the true
softmax over the whole sequence; each call's gradients come out in fp32
(the bf16 kernels' fp32-gradient mode: a chunk's share is larger than
the sum it cancels into, so rounding it first would put the ring's
gradients far from one call's), dq accumulates at home, dk and dv (fp32)
travel with their chunk and are home after ``n`` hops.  Under a causal
mask rank ``r`` launches ``r + 1`` of each K1 kernel a call: the ring is
unbalanced (rank ``n - 1`` works ``n`` times as long as rank 0).

Each step's compute (:func:`ring_fwd_step`, :func:`ring_bwd_step`) is
apart from the rotation, so :func:`ring_schedule_fwd` /
:func:`ring_schedule_bwd` can run the ``n`` ranks' schedules in turn in
one process, on chunks of one full sequence.  On CPU tensors the chunk
calls take the plain versions (``reference_attention_bhsd``, and the
flash backward's math under a given lse); on CUDA tensors they launch
K1a / K1b / K1c or raise.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from .flash_attention import (DEFAULT_BLOCK_K, DEFAULT_BLOCK_Q, NEG_INF,
                              flash_attention_bwd, flash_attention_fwd,
                              reference_attention_bhsd)

__all__ = ["ring_attention_fwd", "ring_attention_bwd", "ring_attention_bhsd",
           "ring_fwd_step", "ring_bwd_step", "ring_schedule_fwd",
           "ring_schedule_bwd"]


def _branch(q_off: int, kv_off: int, causal: bool) -> Optional[bool]:
    """None for a masked chunk, else whether the call is causal."""
    if not causal:
        return False
    if kv_off > q_off:
        return None
    return kv_off == q_off


def _reference_chunk_bwd(q, k, v, out, lse, do, scale, causal):
    """The flash backward's math (fp32) for one pair under a given lse;
    the gradients in fp32, as the CUDA route gives them."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bqd,bkd->bqk", qf, kf) * scale
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool,
                          device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.exp(s - lse[..., None])
    dv = torch.einsum("bqk,bqd->bkd", p, dof)
    dp = torch.einsum("bqd,bkd->bqk", dof, vf)
    delta = (out.float() * dof).sum(-1)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bqk,bkd->bqd", ds, kf) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, qf) * scale
    return dq, dk, dv


def _chunk_fwd(q, k, v, scale, q_off, kv_off, causal):
    """``(out, lse)`` of q against one kv chunk, or None (masked)."""
    c = _branch(q_off, kv_off, causal)
    if c is None:
        return None
    if q.device.type == "cpu":
        return reference_attention_bhsd(q.float(), k.float(), v.float(),
                                        scale, c, return_lse=True)
    return flash_attention_fwd(q, k, v, scale, c, 0, out_fp32=True)


def _chunk_bwd(q, k, v, out, lse, do, scale, q_off, kv_off, causal):
    """``(dq, dk, dv)`` of one pair under the global lse, or None."""
    c = _branch(q_off, kv_off, causal)
    if c is None:
        return None
    if q.device.type == "cpu":
        return _reference_chunk_bwd(q, k, v, out, lse, do, scale, c)
    return flash_attention_bwd(q, k, v, out, lse, do, scale, c, 0,
                               grads_fp32=True)


def ring_fwd_step(q, kc, vc, out, lse, scale, q_off, kv_off, causal):
    """One step's compute: attend the visiting chunk and merge it into
    the running ``out`` (fp32) and ``lse``; returns both."""
    res = _chunk_fwd(q, kc, vc, scale, q_off, kv_off, causal)
    if res is None:
        return out, lse
    o_i, lse_i = res
    m = torch.maximum(lse, lse_i)
    w0 = torch.exp(torch.where(lse == NEG_INF, NEG_INF, lse - m))
    w1 = torch.exp(torch.where(lse_i == NEG_INF, NEG_INF, lse_i - m))
    denom = torch.clamp(w0 + w1, min=1e-30)
    out = out * (w0 / denom)[..., None] + o_i.float() * (w1 / denom)[..., None]
    return out, m + torch.log(denom)


def ring_bwd_step(q, kc, vc, out, lse, do, dq, dkc, dvc, scale, q_off,
                  kv_off, causal):
    """One backward step's compute: the pair's gradients added into
    ``dq`` and the travelling ``dkc`` / ``dvc`` (fp32, in place)."""
    res = _chunk_bwd(q, kc, vc, out, lse, do, scale, q_off, kv_off, causal)
    if res is not None:
        dq.add_(res[0].float())
        dkc.add_(res[1].float())
        dvc.add_(res[2].float())


def _rotate(tensors: List[torch.Tensor], group) -> Tuple[list, list]:
    """Start sending each tensor to the next rank and receiving the
    previous rank's; returns the receive buffers and the work handles."""
    from ..distributed.communication.collective_ops import (
        P2POp, batch_isend_irecv, irecv, isend)
    n, me = group.nranks, group.rank
    nxt, prv = group.ranks[(me + 1) % n], group.ranks[(me - 1) % n]
    bufs = [torch.empty_like(t) for t in tensors]
    ops = [P2POp(isend, t, nxt, group) for t in tensors] + \
        [P2POp(irecv, b, prv, group) for b in bufs]
    return bufs, batch_isend_irecv(ops)


def _wait(works) -> None:
    for w in works:
        w.wait()


def _start(q):
    bh, s, d = q.shape
    return (torch.zeros(bh, s, d, dtype=torch.float32, device=q.device),
            torch.full((bh, s), NEG_INF, dtype=torch.float32,
                       device=q.device))


def ring_attention_fwd(q, k, v, group, scale: float, causal: bool = True):
    """Per rank ``[B*H, S_local, D]`` q, k, v over ``group``'s ring:
    ``(out, lse)`` with ``out`` in q's dtype and the fp32 global lse."""
    n, idx = group.nranks, group.rank
    s_local = q.shape[1]
    out, lse = _start(q)
    kc, vc = k.contiguous(), v.contiguous()
    for i in range(n):
        works = []
        if i < n - 1:
            (kn, vn), works = _rotate([kc, vc], group)
        out, lse = ring_fwd_step(q, kc, vc, out, lse, scale, idx * s_local,
                                 ((idx - i) % n) * s_local, causal)
        _wait(works)
        if i < n - 1:
            kc, vc = kn, vn
    return out.to(q.dtype), lse


def ring_attention_bwd(q, k, v, out, lse, do, group, scale: float,
                       causal: bool = True):
    """The ring backward: ``(dq, dk, dv)`` in the inputs' dtypes."""
    n, idx = group.nranks, group.rank
    s_local = q.shape[1]
    do = do.to(q.dtype).contiguous()
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dkc = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dvc = torch.zeros_like(dkc)
    kc, vc = k.contiguous(), v.contiguous()
    for i in range(n):
        works = []
        if i < n - 1:
            (kn, vn), works = _rotate([kc, vc], group)
        ring_bwd_step(q, kc, vc, out, lse, do, dq, dkc, dvc, scale,
                      idx * s_local, ((idx - i) % n) * s_local, causal)
        # dk / dv ride the ring with their chunk: home after n hops
        (dkc, dvc), more = _rotate([dkc, dvc], group)
        _wait(works + more)
        if i < n - 1:
            kc, vc = kn, vn
    return dq.to(q.dtype), dkc.to(k.dtype), dvc.to(v.dtype)


def ring_schedule_fwd(q_chunks, k_chunks, v_chunks, scale: float,
                      causal: bool = True):
    """The ``n`` ranks' forward schedules run in turn in one process, on
    the chunks of one sequence (rank ``r`` visits chunk ``(r - i) mod
    n`` at step ``i``): each rank's ``(out, lse)``."""
    n = len(q_chunks)
    s_local = q_chunks[0].shape[1]
    res = []
    for r in range(n):
        out, lse = _start(q_chunks[r])
        for i in range(n):
            j = (r - i) % n
            out, lse = ring_fwd_step(q_chunks[r], k_chunks[j], v_chunks[j],
                                     out, lse, scale, r * s_local,
                                     j * s_local, causal)
        res.append((out.to(q_chunks[r].dtype), lse))
    return res


def ring_schedule_bwd(q_chunks, k_chunks, v_chunks, outs, lses, dos,
                      scale: float, causal: bool = True):
    """The ``n`` ranks' backward schedules in turn in one process: each
    chunk's ``(dq, dk, dv)``, dk / dv summed over the ranks that visited
    the chunk, as the ring carries them home."""
    n = len(q_chunks)
    s_local = q_chunks[0].shape[1]
    dqs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
           for q in q_chunks]
    dks = [torch.zeros(k.shape, dtype=torch.float32, device=k.device)
           for k in k_chunks]
    dvs = [torch.zeros_like(d) for d in dks]
    for r in range(n):
        for i in range(n):
            j = (r - i) % n
            ring_bwd_step(q_chunks[r], k_chunks[j], v_chunks[j], outs[r],
                          lses[r], dos[r].to(q_chunks[r].dtype), dqs[r],
                          dks[j], dvs[j], scale, r * s_local, j * s_local,
                          causal)
    dt = q_chunks[0].dtype
    return [(dqs[r].to(dt), dks[r].to(dt), dvs[r].to(dt)) for r in range(n)]


def _check_ring_shapes(q, k):
    """The reference's rule: per-rank lengths aligned to the flash block
    (its Pallas kernels would double-count keys otherwise)."""
    s_local = q.shape[1]
    bq = min(DEFAULT_BLOCK_Q, s_local)
    bk = min(DEFAULT_BLOCK_K, k.shape[1])
    if s_local % bq or k.shape[1] % bk:
        raise ValueError(
            f"ring attention needs per-rank sequence lengths aligned to "
            f"the flash block size ({DEFAULT_BLOCK_Q}); got q={s_local}, "
            f"k={k.shape[1]}")


def _ring_group(axis_name):
    """A Group, or the fleet topology's group of the axis name."""
    if not isinstance(axis_name, str):
        return axis_name
    from ..distributed.fleet.base.topology import get_hybrid_communicate_group
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        raise ValueError(f"axis {axis_name!r}: no fleet topology")
    return {"cp": hcg.get_context_parallel_group,
            "sep": hcg.get_sep_parallel_group,
            "mp": hcg.get_model_parallel_group}[axis_name]()


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, scale, causal):
        out, lse = ring_attention_fwd(q, k, v, group, scale, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (group, scale, causal)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return (*ring_attention_bwd(q, k, v, out, lse, do, *ctx.args),
                None, None, None)


def ring_attention_bhsd(q, k, v, axis_name, scale: float,
                        causal: bool = True, interpret: bool = False):
    """Ring attention of this rank's ``[B*H, S_local, D]`` chunk over
    ``axis_name`` (a ``Group``, or ``"cp"`` / ``"sep"`` of the fleet
    topology), differentiable.  ``interpret`` changes nothing (the CPU
    route is the plain version)."""
    _check_ring_shapes(q, k)
    return _RingAttention.apply(q, k, v, _ring_group(axis_name),
                                float(scale), bool(causal))
