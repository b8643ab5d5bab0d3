"""Decode attention over a paged KV cache, and the page-pool cache;
counterpart of ``paddle_tpu/ops/paged_attention.py``.

The KV cache lives in fixed-size pages ``[num_kv_heads, total_pages,
page_size, head_dim]``; each sequence owns a list of page ids, so
sequences of very different lengths share one pool without
reallocation.

* :func:`paged_attention` (K9's counterpart) — one query token per
  sequence, ``q [B, nh, hd]`` against the pools through ``lengths
  i32[B]`` and ``page_indices i32[B, pages_per_seq]`` -> ``[B, nh, hd]``
  in q's dtype; GQA with ``nh % nkv == 0``.  CPU tensors take
  :func:`paged_attention_ref`, the plain version; CUDA tensors launch
  the hand-written kernel of ``csrc/paged_attention.cu`` (design notes
  there) or raise.
* :class:`PagedKVCache` — the pools as torch tensors on the cache's
  device, updated **in place** (JAX returns new arrays from ``.at[]``);
  the page tables, lengths and free list are host-side Python state, as
  in the JAX package, so a caller reads them without touching the card.
* :class:`PagedLayerView` and :func:`build_paged_caches` — one cache per
  layer for a fixed decode batch, passed through a model's ``past`` slot.

Page tables and write indices reach the card through
:func:`_host_ints`: pinned memory and a non-blocking copy (no host
sync), memoised by content.  Every layer's cache of one decode batch
holds the same tables (the layers allocate in the same order), so a
decode step copies its tables once, not once per layer;
:data:`table_copies` counts the copies.
"""
from __future__ import annotations

import collections
import ctypes
import math
from typing import List, Tuple

import numpy as np
import torch

from ..device import default_device
from . import _build

__all__ = ["paged_attention", "paged_attention_ref", "PagedKVCache",
           "PagedLayerView", "build_paged_caches", "launches",
           "table_copies"]

# kernel launches made by paged_attention (CUDA route only)
launches = 0
# host -> device copies of page tables and write indices (CUDA only)
table_copies = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 256
_MAX_REP = 8          # query heads per kv head the kernel holds in registers
_SMEM_LIMIT = 227 * 1024
_KERNEL_WARPS = 8
_MEMO_SIZE = 64
_memo: "collections.OrderedDict" = collections.OrderedDict()


def paged_attention_ref(q, k_pages, v_pages, lengths, page_indices):
    """Plain version, the JAX reference op for op: gather each sequence's
    pages densely, fp32 scores scaled by ``1/sqrt(hd)``, positions at or
    past ``lengths`` masked with the fp32 minimum, GQA by repeat; a
    zero-length row is exactly 0; the result in q's dtype."""
    b, nh, hd = q.shape
    nkv, _, ps, _ = k_pages.shape
    rep = nh // nkv
    ppseq = page_indices.shape[1]
    tbl = page_indices.long()
    k = k_pages[:, tbl].transpose(0, 1).reshape(b, nkv, ppseq * ps, hd)
    v = v_pages[:, tbl].transpose(0, 1).reshape(b, nkv, ppseq * ps, hd)
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    scores = torch.einsum("bhd,bhtd->bht", q.float(), k.float()) \
        / np.sqrt(hd)
    lens = lengths.to(torch.int32).to(q.device)
    pos = torch.arange(ppseq * ps, device=q.device)[None, None, :]
    mask = pos < lens[:, None, None]
    scores = torch.where(mask, scores, torch.finfo(torch.float32).min)
    p = torch.softmax(scores, dim=-1)
    p = torch.where(lens[:, None, None] > 0, p, 0.0)
    return torch.einsum("bht,bhtd->bhd", p, v.float()).to(q.dtype)


def _check_cuda(q, k_pages, v_pages, lengths, page_indices):
    dev = q.device
    named = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
             "lengths": lengths, "page_indices": page_indices}
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError("q must be [B, nh, hd] and the pools "
                         "[nkv, P, ps, hd]")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype \
            or v_pages.shape != k_pages.shape:
        raise ValueError("q, k_pages and v_pages must share one dtype and "
                         "the pools one shape")
    for name in ("lengths", "page_indices"):
        if named[name].dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got "
                            f"{named[name].dtype}")
    b, nh, hd = q.shape
    nkv, _, _, khd = k_pages.shape
    if khd != hd:
        raise ValueError(f"head_dim differs: q {hd}, pools {khd}")
    if nh % nkv:
        raise ValueError(f"nh={nh} is not a multiple of nkv={nkv}")
    if nh // nkv > _MAX_REP:
        raise ValueError(f"{nh // nkv} query heads per kv head > "
                         f"{_MAX_REP}")
    if hd > _MAX_HEAD_DIM or hd % 8:
        raise ValueError(f"head_dim {hd} is not a multiple of 8 up to "
                         f"{_MAX_HEAD_DIM}")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("the pools must be 16-byte aligned")
    if lengths.shape != (b,) or page_indices.dim() != 2 \
            or page_indices.shape[0] != b:
        raise ValueError("lengths must be [B] and page_indices "
                         "[B, pages_per_seq]")
    smem = 4 * (_KERNEL_WARPS * (nh // nkv) * (hd + 2)
                + page_indices.shape[1])
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{page_indices.shape[1]} pages per sequence do "
                         "not fit in shared memory")


def paged_attention(q, k_pages, v_pages, lengths, page_indices,
                    pages_per_compute_block: int = 4):
    """Decode attention over a paged KV cache (layout in the module
    docstring).  CPU tensors take the plain version (which autograd can
    differentiate); CUDA tensors launch the kernel on the current stream,
    or raise — also when an input needs a gradient, since the kernel has
    no backward.

    ``pages_per_compute_block`` is accepted for the JAX signature.  The
    TPU kernel copies that many pages per grid step; the CUDA kernel has
    no such block: each warp walks single positions of the live pages, so
    the value does not change what it computes or how."""
    del pages_per_compute_block
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, lengths,
                                   page_indices)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k_pages, v_pages)):
        raise RuntimeError("paged_attention's CUDA kernel has no backward: "
                           "call it under torch.no_grad(), or on CPU "
                           "tensors for the differentiable plain version")
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_cuda(q, k_pages, v_pages, lengths, page_indices)
    b, nh, hd = q.shape
    nkv, n_pages, ps, _ = k_pages.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.library("paged_attention")
    # the CUDA runtime launches on the calling thread's current device
    with torch.cuda.device(q.device):
        rc = lib.pa_forward(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            lengths.data_ptr(), page_indices.data_ptr(), out.data_ptr(), b,
            nh, nkv, n_pages, ps, hd, page_indices.shape[1],
            1.0 / math.sqrt(hd), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {rc}")
    global launches
    launches += 1
    return out


def _host_ints(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host integer array as a tensor on ``device``.  On CUDA the copy
    goes through pinned memory without blocking the host, and is
    memoised by content: the result is shared, so callers only read it."""
    if device.type != "cuda":
        return torch.from_numpy(arr).to(device)
    key = (str(device), arr.dtype.str, arr.shape, arr.tobytes())
    hit = _memo.get(key)
    if hit is not None:
        _memo.move_to_end(key)
        return hit
    out = torch.from_numpy(arr).pin_memory().to(device, non_blocking=True)
    global table_copies
    table_copies += 1
    _memo[key] = out
    if len(_memo) > _MEMO_SIZE:
        _memo.popitem(last=False)
    return out


def _torch_dtype(dtype) -> torch.dtype:
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, dtype)


class PagedKVCache:
    """Page-pool KV cache for batched decode: fixed-size pages, a page
    table per sequence, a free list; appending a token never reallocates,
    freeing a sequence returns its pages.  The pools live on ``device``
    (``None``: the CUDA card, raising without one) and are written in
    place; tables and lengths are host-side state."""

    def __init__(self, num_pages: int, page_size: int, num_kv_heads: int,
                 head_dim: int, max_pages_per_seq: int,
                 dtype="float32", device=None):
        self.page_size = int(page_size)
        self.max_pages_per_seq = int(max_pages_per_seq)
        dev = default_device(device)
        self.k_pages = torch.zeros(
            (num_kv_heads, num_pages, page_size, head_dim),
            dtype=_torch_dtype(dtype), device=dev)
        self.v_pages = torch.zeros_like(self.k_pages)
        self._free: List[int] = list(range(num_pages))[::-1]
        # seq id -> (page id list, current length)
        self._seqs: dict = {}

    @property
    def device(self) -> torch.device:
        return self.k_pages.device

    # -- scheduling ------------------------------------------------------
    def allocate(self, seq_id) -> None:
        if seq_id in self._seqs:
            raise ValueError(f"sequence {seq_id!r} already allocated")
        self._seqs[seq_id] = ([], 0)

    def free(self, seq_id) -> None:
        pages, _ = self._seqs.pop(seq_id)
        self._free.extend(reversed(pages))

    def length(self, seq_id) -> int:
        return self._seqs[seq_id][1]

    def _page_for_next_token(self, seq_id) -> Tuple[int, int]:
        pages, length = self._seqs[seq_id]
        slot = length % self.page_size
        if slot == 0:   # need a fresh page
            if len(pages) >= self.max_pages_per_seq:
                raise RuntimeError(
                    f"sequence {seq_id!r} exceeds max_pages_per_seq")
            if not self._free:
                raise RuntimeError("KV page pool exhausted")
            pages.append(self._free.pop())
        return pages[-1], slot

    def _advance(self, seq_id, n: int) -> None:
        pages, length = self._seqs[seq_id]
        self._seqs[seq_id] = (pages, length + n)

    def _scatter(self, pages, slots, k_rows, v_rows) -> None:
        """Write ``k/v_rows [n, nkv, hd]`` at ``(pages[i], slots[i])``: one
        indexed write per pool."""
        idx = _host_ints(np.asarray([pages, slots], np.int64), self.device)
        for pool, rows in ((self.k_pages, k_rows), (self.v_pages, v_rows)):
            pool[:, idx[0], idx[1]] = rows.transpose(0, 1).to(pool.dtype)

    # -- writes ----------------------------------------------------------
    def append(self, seq_id, k_tok, v_tok) -> None:
        """Append one token's K/V ([num_kv_heads, head_dim]) to a
        sequence."""
        page, slot = self._page_for_next_token(seq_id)
        self.k_pages[:, page, slot] = k_tok.to(self.k_pages.dtype)
        self.v_pages[:, page, slot] = v_tok.to(self.v_pages.dtype)
        self._advance(seq_id, 1)

    def append_batch(self, seq_ids, k_batch, v_batch) -> None:
        """Append one token per sequence with one write per pool (the
        decode hot path).  k/v_batch: [B, num_kv_heads, head_dim]."""
        pages, slots = [], []
        for sid in seq_ids:
            page, slot = self._page_for_next_token(sid)
            pages.append(page)
            slots.append(slot)
            self._advance(sid, 1)
        self._scatter(pages, slots, k_batch, v_batch)

    def prefill(self, seq_id, k_seq, v_seq) -> None:
        """Bulk-append a prompt's K/V ([T, num_kv_heads, head_dim]) with
        one write per pool; pages are taken as the JAX cache takes them,
        so the pools end up with the same bytes."""
        pages, slots = [], []
        t, total = 0, k_seq.shape[0]
        while t < total:
            page, slot = self._page_for_next_token(seq_id)
            n = min(self.page_size - slot, total - t)
            pages += [page] * n
            slots += range(slot, slot + n)
            self._advance(seq_id, n)
            t += n
        if total:
            self._scatter(pages, slots, k_seq, v_seq)

    # -- reads -----------------------------------------------------------
    def batch_tables(self, seq_ids):
        """(lengths i32[B], page_indices i32[B, max_pages_per_seq]) on the
        cache's device, for a decode batch.  Unused table slots hold page
        0; nothing reads them (the kernel stops at ``lengths``, the plain
        version masks them).  The tensors may be shared: read only."""
        b, ppseq = len(seq_ids), self.max_pages_per_seq
        # one array, one copy: the lengths, then the tables row by row
        packed = np.zeros((b + b * ppseq,), np.int32)
        tables = packed[b:].reshape(b, ppseq)
        for i, sid in enumerate(seq_ids):
            pages, length = self._seqs[sid]
            packed[i] = length
            tables[i, :len(pages)] = pages
        dev = _host_ints(packed, self.device)
        return dev[:b], dev[b:].view(b, ppseq)

    def attend(self, q, seq_ids):
        """Decode attention for a batch: q [B, num_heads, head_dim]."""
        lengths, tables = self.batch_tables(seq_ids)
        return paged_attention(q, self.k_pages, self.v_pages, lengths,
                               tables)


class PagedLayerView:
    """One layer's handle on a :class:`PagedKVCache` for a fixed decode
    batch, passed through a model's ``past`` slot: the attention layer
    dispatches on it, appends the new token's K/V to the pages and
    attends through :func:`paged_attention`.  The view is its own new
    past (the pools change in place)."""

    def __init__(self, cache: PagedKVCache, seq_ids):
        self.cache = cache
        self.seq_ids = list(seq_ids)

    def lengths_np(self) -> np.ndarray:
        return np.asarray([self.cache.length(s) for s in self.seq_ids],
                          "int32")

    def append_and_attend(self, q, k, v):
        """q [B, 1, nh, hd]; k/v [B, 1, nkv, hd] (post-rope) -> [B, nh, hd]
        attention over each sequence's context including the token being
        appended."""
        self.cache.append_batch(self.seq_ids, k[:, 0], v[:, 0])
        return self.cache.attend(q[:, 0].contiguous(), self.seq_ids)


def build_paged_caches(n_layers: int, batch: int, max_len: int,
                       num_kv_heads: int, head_dim: int,
                       page_size: int = 16, dtype="float32", device=None):
    """Per-layer caches + views for a decode batch of ``batch`` sequences
    bounded by ``max_len`` tokens each."""
    ppseq = -(-int(max_len) // int(page_size))
    views = []
    for _ in range(n_layers):
        cache = PagedKVCache(num_pages=batch * ppseq, page_size=page_size,
                             num_kv_heads=num_kv_heads, head_dim=head_dim,
                             max_pages_per_seq=ppseq, dtype=dtype,
                             device=device)
        for b in range(batch):
            cache.allocate(b)
        views.append(PagedLayerView(cache, range(batch)))
    return views


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pa_forward.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i,
                               ctypes.c_float, i, p]
    lib.pa_forward.restype = ctypes.c_int


_build.register("paged_attention", _declare)
