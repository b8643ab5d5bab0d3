"""Ragged paged attention — ONE kernel launch for a mixed prefill/decode
serving batch; counterpart of ``paddle_tpu/ops/pallas/
ragged_paged_attention.py``.

Layout (the JAX package's):

* ``q [B, Q, nh, hd]`` — per-sequence query chunks padded to the
  batch's widest chunk ``Q``; query token ``i`` of sequence ``b`` sits at
  absolute position ``kv_lens[b] - q_lens[b] + i``;
* ``k_pages/v_pages [nkv, P, ps, hd]`` — the shared page pools, new
  tokens already appended;
* ``kv_lens i32[B]`` (post-append context lengths), ``q_lens i32[B]``
  (valid query rows), ``page_tables i32[B, ppseq]``.

Returns ``[B, Q, nh, hd]`` in q's dtype.  Rows ``i >= q_lens[b]`` are
padding: the kernel writes 0 there, the plain version (like the JAX
one) leaves them finite and undefined.  A row with nothing to attend to
(``q_lens[b] == 0`` slots included) is exactly 0 in both.

On CUDA tensors :func:`ragged_paged_attention` launches the hand-written
kernel ``csrc/ragged_paged_attention.cu`` (design notes there) or
raises; on CPU tensors it takes :func:`ragged_paged_attention_ref`, the
plain version the CPU tests and ``chip_smoke.py`` hold the kernel to.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["ragged_paged_attention", "ragged_paged_attention_ref",
           "append_positions", "launches"]

# kernel launches made by ragged_paged_attention (CUDA route only)
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 256
_SMEM_LIMIT = 227 * 1024 - 64
_ROWS = 8              # query rows per block (a row group), as the kernel
_MAX_Z = 65535         # grid.z = B * splits


def append_positions(kv_lens, tables, live, page_size, sink):
    """Page-append cursors for ONE decode token per lane: where lane
    ``b``'s next k/v row lands given its current ``kv_lens [B]`` and
    ``tables [B, ppseq]``.  Returns ``(page_ids [B], slots [B])`` int32;
    lanes with ``live`` False target the ``sink`` page at slot 0."""
    kv = kv_lens.to(torch.int32)
    lanes = torch.arange(kv.shape[0], device=kv.device)
    ps = int(page_size)
    # a dead lane's cursor may run past its table; JAX clamps that
    # gather, and the value is replaced by the sink anyway
    col = (kv // ps).clamp(max=tables.shape[1] - 1).long()
    sink_t = torch.full_like(kv, int(sink))
    page_ids = torch.where(live, tables[lanes, col].to(torch.int32), sink_t)
    slots = torch.where(live, kv % ps, torch.zeros_like(kv))
    return page_ids, slots


def ragged_paged_attention_ref(q, k_pages, v_pages, kv_lens, q_lens,
                               page_tables, scale=None):
    """Dense-gather plain version: collect each sequence's pages and run
    masked attention with the ragged causal alignment.  fp32 logits,
    ``-1e30`` mask, and a row with no attendable position is exactly 0
    (the JAX reference's rules)."""
    b, qw, nh, hd = q.shape
    nkv, _, ps, _ = k_pages.shape
    rep = nh // nkv
    ppseq = page_tables.shape[1]
    t = ppseq * ps
    sc = scale if scale is not None else 1.0 / math.sqrt(hd)
    dev = q.device
    kv_lens = kv_lens.to(torch.int32)
    q_lens = q_lens.to(torch.int32)
    tbl = page_tables.long()
    # [B, nkv, T, hd] gathered per sequence, GQA-broadcast to nh
    k = k_pages[:, tbl].transpose(0, 1).reshape(b, nkv, t, hd)
    v = v_pages[:, tbl].transpose(0, 1).reshape(b, nkv, t, hd)
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    qt = q.transpose(1, 2).float()                          # [B, nh, Q, hd]
    logits = torch.einsum("bhqd,bhtd->bhqt", qt, k.float()) * sc
    kvpos = torch.arange(t, dtype=torch.int32, device=dev)
    qpos = (kv_lens - q_lens)[:, None] \
        + torch.arange(qw, dtype=torch.int32, device=dev)[None, :]
    mask = (kvpos[None, None, :] <= qpos[:, :, None]) \
        & (kvpos[None, None, :] < kv_lens[:, None, None])   # [B, Q, T]
    logits = torch.where(mask[:, None], logits,
                         torch.tensor(-1e30, dtype=torch.float32,
                                      device=dev))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(mask.any(dim=-1)[:, None, :, None], probs,
                        torch.zeros((), dtype=torch.float32, device=dev))
    ctx = torch.einsum("bhqt,bhtd->bhqd", probs, v.float())
    return ctx.transpose(1, 2).to(q.dtype)


def _check_cuda(q, k_pages, v_pages, kv_lens, q_lens, page_tables):
    dev = q.device
    named = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
             "kv_lens": kv_lens, "q_lens": q_lens,
             "page_tables": page_tables}
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dim() != 4 or k_pages.dim() != 4:
        raise ValueError("q must be [B, Q, nh, hd] and the pools "
                         "[nkv, P, ps, hd]")
    if q.dtype not in _DTYPE_CODE or k_pages.dtype not in _DTYPE_CODE:
        raise TypeError(f"q and the pools must be float32 or bfloat16, "
                        f"got {q.dtype} and {k_pages.dtype}")
    if v_pages.dtype != k_pages.dtype or v_pages.shape != k_pages.shape:
        raise ValueError("k_pages and v_pages differ in dtype or shape")
    for name in ("kv_lens", "q_lens", "page_tables"):
        if named[name].dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got "
                            f"{named[name].dtype}")
    b, _, nh, hd = q.shape
    nkv, _, ps, khd = k_pages.shape
    if khd != hd:
        raise ValueError(f"head_dim differs: q {hd}, pools {khd}")
    if nh % nkv:
        raise ValueError(f"nh={nh} is not a multiple of nkv={nkv}")
    if hd > _MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} > {_MAX_HEAD_DIM}")
    # one stage of the prefill ring (a K and a V page) and the run's page
    # ids; the kernel's launcher refuses any other layout that does not fit
    if 2 * ps * hd * k_pages.element_size() + 4 * page_tables.shape[-1] \
            > _SMEM_LIMIT:
        raise ValueError(f"a page tile ps={ps} x hd={hd} does not fit "
                         "in shared memory")
    if kv_lens.shape != (b,) or q_lens.shape != (b,) \
            or page_tables.dim() != 2 or page_tables.shape[0] != b:
        raise ValueError("kv_lens/q_lens must be [B] and page_tables "
                         "[B, ppseq]")


_sm_count = {}
_partials = {}
_counters = {}


def _splits(groups: int, batch: int, ppseq: int, dev) -> int:
    """Page runs per row group: enough that the grid holds about two
    blocks per SM (decode), no more than the table has pages, and 1
    where the row groups alone fill the card (prefill)."""
    sms = _sm_count.get(dev)
    if sms is None:
        sms = _sm_count[dev] = \
            torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = groups * batch
    if blocks >= 2 * sms:
        return 1
    return max(1, min(-(-2 * sms // blocks), ppseq, _MAX_Z // batch))


def _scratch(dev, groups: int, splits: int, hd: int):
    """(fp32 partial states, zeroed per-group counters) for a split
    launch, kept per device and grown on demand.  The kernel leaves every
    counter it used at 0, so one pair serves every launch on its
    stream."""
    need = groups * splits * _ROWS * (hd + 2)
    part = _partials.get(dev)
    if part is None or part.numel() < need:
        part = _partials[dev] = torch.empty(need, dtype=torch.float32,
                                            device=dev)
    cnt = _counters.get(dev)
    if cnt is None or cnt.numel() < groups:
        cnt = _counters[dev] = torch.zeros(max(groups, 4096),
                                           dtype=torch.int32, device=dev)
    return part, cnt


def ragged_paged_attention(q, k_pages, v_pages, kv_lens, q_lens,
                           page_tables, scale=None):
    """One-launch mixed prefill/decode attention over paged KV (layout in
    the module docstring).  CPU tensors take the plain version; CUDA
    tensors launch the kernel on the current stream, or raise."""
    if q.device.type == "cpu":
        return ragged_paged_attention_ref(q, k_pages, v_pages, kv_lens,
                                          q_lens, page_tables, scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_cuda(q, k_pages, v_pages, kv_lens, q_lens, page_tables)
    b, qw, nh, hd = q.shape
    nkv, n_pages, ps, _ = k_pages.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    ppseq = page_tables.shape[1]
    groups = -(-(nh // nkv * qw) // _ROWS) * nkv
    splits = _splits(groups, b, ppseq, q.device)
    part = cnt = None
    if splits > 1:
        part, cnt = _scratch(q.device, groups * b, splits, hd)
    lib = _build.library("ragged_paged_attention")
    # the CUDA runtime launches on the calling thread's current device
    with torch.cuda.device(q.device):
        rc = lib.rpa_forward(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            kv_lens.data_ptr(), q_lens.data_ptr(), page_tables.data_ptr(),
            out.data_ptr(), part.data_ptr() if part is not None else None,
            cnt.data_ptr() if cnt is not None else None, b, qw, nh, nkv,
            n_pages, ps, hd, ppseq, splits, float(scale),
            _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pages.dtype],
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ragged_paged_attention kernel launch failed: "
                           f"CUDA error {rc}")
    global launches
    launches += 1
    return out


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rpa_forward.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i,
                                i, i, i, i, ctypes.c_float, i, i, p]
    lib.rpa_forward.restype = ctypes.c_int


_build.register("ragged_paged_attention", _declare)
