"""The decode-step kernels of the compiled decode loop; counterpart of
``paddle_tpu/ops/pallas/fused_decode.py``.

* :func:`rope_qkv` (K6a) — the q/k/v projections of one token per row
  of ``x [B, H]``, fp32 sums, optional biases, q and k rotated by one
  position's ``cos_row/sin_row [hd]`` (interleaved or neox);
* :func:`attend_cache_append` (K6b) — append ``k_new/v_new`` at ``pos``
  of the ``[B, S_total, nkv, hd]`` caches and attend ``q`` to positions
  ``0..pos`` (GQA: ``nh / nkv`` query heads share a kv head).  The
  caches are updated **in place** (the JAX kernel aliases them to its
  outputs); the returned caches are the same tensors;
* :func:`norm_mlp` (K6c) — LayerNorm -> ``w1 + b1`` -> gelu -> ``w2 +
  b2`` (``kind="layer_norm"``, GPT) or RMSNorm -> ``act(h @ w_gate) *
  (h @ w1)`` -> ``w2`` (``kind="rms_norm"``, LLaMA; ``act`` silu or
  gelu_tanh), with fp32 statistics.  The residual add stays with the
  caller.  On the card the up (and gate) and the down products are two
  launches (the down product needs every column of the up and gate
  products, kept in an fp32 scratch), after a small one that normalizes
  x on the stream route's resident form; ``launches["norm_mlp"]`` counts
  one per call;
* :func:`norm_matmul` (K6d) — ``norm(x) @ w`` over ``x [..., H]`` and
  ``w [H, N]`` (LayerNorm with weight and optional bias, or RMSNorm),
  fp32 statistics, fp32 normalised rows and fp32 sums, the result cast to
  x's dtype, then ``+ bias``.  It is what the kernel-claim pass of
  ``static.passes`` rewrites a captured norm -> ``linear``/``matmul``
  chain onto.  ``w`` may be row-major (a ``linear`` weight) or the
  transposed view of a row-major ``[N, H]`` tensor (a ``transpose_y``
  head); each layout has its own loop on the card.

**Routes of K6a, K6c and K6d on the card.**  :func:`fd_route` (the twin
of ``csrc/fused_decode.cu``'s ``fd_route``) sends a product to the
persistent weight-streaming kernel (``"stream"``: rows 1..64, fp32 or
bf16, 16-byte aligned pointers, N, K and the row stride multiples of the
16-byte vector) or to the generic GEMV (``"generic"``: the rest, such as
odd widths or unaligned views); :func:`norm_matmul_route` and
:func:`norm_mlp_route` name a call's route.  K6a's stream form
(:func:`qkv_route`, the twin of ``fd_qkv_route``; :func:`rope_qkv_route`
names a call's route) is one launch over q's, k's and v's tiles at 1..8
rows: fp32 on the CUDA cores, bf16 on the tensor cores
(``mma.m16n8k16``), the bias and the rope of each column pair in its
epilogue; it leaves to the generic GEMV more rows, a neox head dim that
does not divide a tile's 512 bytes of columns, and a K whose window of
x does not fit.  The stream kernel's grid and
its shares of the weight are :func:`stream_plan`'s, a pure function of
the tiles, the steps and the blocks the card holds; a tile cut by a
share boundary is summed from :func:`stream_contributors`' parts in block
order.  The route depends on shapes and pointers only, never on whether a
build or a launch failed.

Each has a plain version (``*_ref``) that mirrors the JAX package's jnp
reference exactly (same op order and casts: ``reference_rms_norm``
casts the rsqrt back to the input dtype before the weight multiply, the
attention casts its fp32 probabilities to q's dtype before ``PV``).
CPU tensors take it.  CUDA tensors that the gate admits launch the
hand-written kernels of ``csrc/fused_decode.cu`` (design notes there)
or raise; CUDA tensors it does not admit take the same composition with
``torch.matmul``.  That is routing by shape, as the JAX package routes
to its Pallas kernels: there is no ``try`` and no flag that turns the
kernels off.

**The card's gate.**  The JAX package admits a kernel only while its
weights (K6a, K6c) or one row's cache (K6b) fit a 10 MiB VMEM budget,
because its TPU kernels hold them whole in VMEM; at served widths that
shuts K6a and K6c off (llama2-7b's q/k/v weights are 192 MiB in fp32).
The CUDA kernels stream weights and cache from device memory and have
no such limit, so the byte rules are dropped.  Kept are the JAX gate's
semantic rules: an even head dim (rope pairs), ``nh % nkv == 0``.
Added are what the kernels need: fp32 or bf16 with one dtype across x,
weights and caches, weights whose columns are contiguous (any row
stride: GPT's q/k/v are column slices of its packed projection), at
most 8 query heads per kv head and a head dim of at most 256 (K6b's
registers), and one row rule: at most ``NORM_MLP_MAX_ROWS`` = 64 rows go
to K6c.  Above that the GEMV design (each block re-streams the weights
per 8 rows) loses to the library's GEMM, so larger products take the
composition, as the JAX package leaves large products to XLA.  K6d
keeps the same row rule (at most 64 rows of x) and drops the JAX gate's
10 MiB weight budget and its multiple-of-8 rule; it takes one dtype
(fp32 or bf16) across x, the weight and the bias, and a weight with
contiguous rows or contiguous columns.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["reference_rope_rows", "reference_rms_norm",
           "reference_layer_norm", "rope_qkv", "rope_qkv_ref",
           "rope_qkv_admits", "attend_cache_append",
           "attend_cache_append_ref", "attend_admits", "norm_mlp",
           "norm_mlp_ref", "norm_mlp_admits", "norm_matmul",
           "norm_matmul_ref", "norm_matmul_admits", "NORM_MLP_MAX_ROWS",
           "fd_route", "norm_matmul_route", "norm_mlp_route", "qkv_route",
           "rope_qkv_route",
           "stream_geometry", "stream_plan", "stream_shares",
           "stream_contributors", "StreamPlan", "launches"]

# kernel launches (CUDA route only); norm_mlp counts one per call (two
# kernels)
launches = {"rope_qkv": 0, "attend_cache_append": 0, "norm_mlp": 0,
            "norm_matmul": 0}

NORM_MLP_MAX_ROWS = 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_NORM_CODE = {"layer_norm": 1, "rms_norm": 2}
_SILU, _GELU_TANH, _GELU = 1, 2, 3
# csrc/fused_decode.cu's GEMV geometry: 32 column pairs x 8 rows a block,
# 256 threads; a split of K keeps at least this many rows
_TILE_PAIRS, _ROWS, _THREADS, _MIN_SPLIT_K = 32, 8, 256, 512
# csrc/fused_decode.cu's stream kernel: a unit is 32 stage rows of 512
# bytes; launch kinds of fd_stream_occupancy
_STAGE_ROWS, _SEG_BYTES = 32, 512
_K6D, _K6C_UP, _K6C_DOWN, _K6A = 0, 1, 2, 3
# csrc/fused_decode.cu's K6a stream form: up to 8 rows (its window), the
# dynamic shared memory a block may use, and the least weight bytes it takes
_QKV_MAX_ROWS, _SMEM_BUDGET = 8, 227 * 1024


# ---------------------------------------------------------------------------
# plain versions — mirrors of the JAX package's jnp references
# ---------------------------------------------------------------------------

def reference_rope_rows(x, cos_row, sin_row, neox: bool = False):
    """Rotate ``x [..., D]`` by one position row (``cos/sin [D]``)."""
    if neox:
        x1, x2 = x.chunk(2, dim=-1)
        rot = torch.cat([-x2, x1], dim=-1)
    else:
        rot = torch.stack([-x[..., 1::2], x[..., 0::2]],
                          dim=-1).reshape(x.shape)
    return x * cos_row + rot * sin_row


def reference_rms_norm(v, w, eps: float):
    """fp32 variance, the rsqrt cast back to the input dtype BEFORE the
    weight multiply (the JAX ``reference_rms_norm``; not
    ``ops.rms_norm.rms_norm_ref``'s fp32 numerics)."""
    var = v.float().square().mean(dim=-1, keepdim=True)
    return v * torch.rsqrt(var + eps).to(v.dtype) * w


def reference_layer_norm(v, w, b, eps: float):
    """fp32 statistics, the normalized value cast back to the input dtype
    before ``* w + b``."""
    v32 = v.float()
    m = v32.mean(dim=-1, keepdim=True)
    var = (v32 - m).square().mean(dim=-1, keepdim=True)
    out = ((v32 - m) * torch.rsqrt(var + eps)).to(v.dtype)
    return out * w + b


def rope_qkv_ref(x, wq, wk, wv, bq=None, bk=None, bv=None, cos_row=None,
                 sin_row=None, *, n_heads, n_kv, head_dim, neox=False):
    b = x.shape[0]
    q, k, v = torch.matmul(x, wq), torch.matmul(x, wk), torch.matmul(x, wv)
    if bq is not None:
        q = q + bq
    if bk is not None:
        k = k + bk
    if bv is not None:
        v = v + bv
    q = q.reshape(b, n_heads, head_dim)
    k = k.reshape(b, n_kv, head_dim)
    v = v.reshape(b, n_kv, head_dim)
    if cos_row is not None:
        # the rotation in the tables' promoted dtype, as in the JAX
        # reference, then back to x's dtype, the kernel's output dtype
        q = reference_rope_rows(q, cos_row, sin_row, neox).to(x.dtype)
        k = reference_rope_rows(k, cos_row, sin_row, neox).to(x.dtype)
    return q, k, v


def attend_cache_append_ref(q, k_new, v_new, k_cache, v_cache, pos,
                            scale=None):
    """The cache append (in place) and the eager decode step's masked
    attention over the whole cache: fp32 logits, ``-1e30`` mask, fp32
    softmax cast back to q's dtype before ``PV``."""
    b, nh, hd = q.shape
    st, nkv = k_cache.shape[1], k_cache.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    k_cache[:, pos] = k_new.to(k_cache.dtype)
    v_cache[:, pos] = v_new.to(v_cache.dtype)
    rep = nh // nkv
    k = k_cache.repeat_interleave(rep, dim=2) if rep > 1 else k_cache
    v = v_cache.repeat_interleave(rep, dim=2) if rep > 1 else v_cache
    logits = torch.einsum("bhsd,bhtd->bhst", q[:, :, None],
                          k.transpose(1, 2)).float() * scale
    valid = torch.arange(st, device=q.device) <= pos
    logits = torch.where(valid, logits, torch.tensor(
        -1e30, dtype=torch.float32, device=q.device))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    ctx = torch.einsum("bhst,bhtd->bhsd", probs, v.transpose(1, 2))
    return ctx[:, :, 0], k_cache, v_cache


def _gelu(a, act):
    return F.gelu(a, approximate="tanh" if act == "gelu_tanh" else "none")


def norm_mlp_ref(x, *, kind, norm_w, norm_b=None, w1, b1=None, w2, b2=None,
                 w_gate=None, eps=1e-5, act="silu"):
    if kind == "layer_norm":
        h = reference_layer_norm(x, norm_w, norm_b, eps)
        a = torch.matmul(h, w1)
        if b1 is not None:
            a = a + b1
        y = torch.matmul(_gelu(a, act), w2)
        return y + b2 if b2 is not None else y
    h = reference_rms_norm(x, norm_w, eps)
    g = torch.matmul(h, w_gate)
    g = _gelu(g, "gelu_tanh") if act == "gelu_tanh" else F.silu(g)
    return torch.matmul(g * torch.matmul(h, w1), w2)


def norm_matmul_ref(x, norm_w, norm_b, w, bias=None, *, kind, eps):
    """The JAX reference branch of ``norm_matmul``: the norm of
    ``reference_layer_norm`` / ``reference_rms_norm`` on the rows of x,
    ``torch.matmul`` with w, then ``+ bias``."""
    h, n = w.shape
    x2 = x.reshape(-1, h)
    if kind == "layer_norm":
        hn = reference_layer_norm(x2, norm_w,
                                  0.0 if norm_b is None else norm_b, eps)
    else:
        hn = reference_rms_norm(x2, norm_w, eps)
    out = torch.matmul(hn, w).reshape(*x.shape[:-1], n)
    return out + bias if bias is not None else out


# ---------------------------------------------------------------------------
# the card's gate
# ---------------------------------------------------------------------------

def _same_float(x, *ts) -> bool:
    return x.dtype in _DTYPE_CODE and all(
        t.dtype == x.dtype and t.dim() == 2 and t.stride(-1) == 1
        for t in ts)


def rope_qkv_admits(x, wq, wk, wv, n_heads, n_kv, head_dim) -> bool:
    """K6a takes it: an even head dim, ``nh % nkv == 0``, and x and the
    weights in one dtype (fp32 or bf16) with contiguous columns."""
    return (head_dim % 2 == 0 and n_heads % n_kv == 0 and x.dim() == 2
            and _same_float(x, wq, wk, wv))


def attend_admits(q, k_cache, v_cache) -> bool:
    """K6b takes it: ``nh % nkv == 0`` with at most 8 query heads per kv
    head, a head dim of at most 256, one dtype (fp32 or bf16), contiguous
    caches (they are updated in place)."""
    nh, hd = q.shape[1], q.shape[2]
    nkv = k_cache.shape[2]
    return (nh % nkv == 0 and nh // nkv <= 8 and hd <= 256
            and q.dtype in _DTYPE_CODE
            and k_cache.dtype == v_cache.dtype == q.dtype
            and k_cache.is_contiguous() and v_cache.is_contiguous())


def norm_mlp_admits(x, w1, w2, w_gate=None) -> bool:
    """K6c takes it: at most ``NORM_MLP_MAX_ROWS`` rows, x and the weights
    in one dtype (fp32 or bf16) with contiguous columns."""
    ws = (w1, w2) if w_gate is None else (w1, w2, w_gate)
    return (x.dim() == 2 and x.shape[0] <= NORM_MLP_MAX_ROWS
            and _same_float(x, *ws))


def _w_layout(w):
    """(transposed, row stride) of a 2-D weight K6d can stream: contiguous
    rows ``[H, N]`` (0, stride 0) or the transposed view of a row-major
    ``[N, H]`` tensor (1, stride 1); None otherwise."""
    h, n = w.shape
    if w.stride(1) == 1 and (w.stride(0) >= n or h == 1):
        return 0, w.stride(0)
    if w.stride(0) == 1 and (w.stride(1) >= h or n == 1):
        return 1, w.stride(1)
    return None


def norm_matmul_admits(x, w, bias=None) -> bool:
    """K6d takes it: at most ``NORM_MLP_MAX_ROWS`` rows of x, x, w and the
    bias in one dtype (fp32 or bf16), a 2-D weight with contiguous rows or
    columns, and a 1-D bias."""
    rows = x.numel() // x.shape[-1] if x.dim() and x.shape[-1] else 0
    return (x.dim() >= 1 and rows <= NORM_MLP_MAX_ROWS
            and x.dtype in _DTYPE_CODE and w.dim() == 2
            and w.dtype == x.dtype and _w_layout(w) is not None
            and (bias is None or (bias.dtype == x.dtype
                                  and bias.dim() == 1)))


# ---------------------------------------------------------------------------
# the stream route of K6c and K6d: its rule and its plan (pure functions)
# ---------------------------------------------------------------------------

def fd_route(transposed: bool, rows: int, n: int, k: int, ldw: int, dtype,
             aligned: bool) -> int:
    """Twin of ``csrc/fused_decode.cu``'s ``fd_route``: 1 where the stream
    kernel takes a product of ``rows`` rows against ``n`` columns over
    ``k`` (a weight of row stride ``ldw``, transposed or not), 0 where the
    generic GEMV does."""
    if dtype not in _DTYPE_CODE:
        return 0
    v = 16 // dtype.itemsize
    return int(bool(aligned) and 1 <= rows <= NORM_MLP_MAX_ROWS and n > 0
               and k > 0 and n % v == 0 and k % v == 0 and ldw % v == 0
               and ldw >= (k if transposed else n))


def _aligned(*ts) -> bool:
    return all(t is None or t.data_ptr() % 16 == 0 for t in ts)


def norm_matmul_route(x, w) -> str:
    """``"stream"`` or ``"generic"``: the route K6d takes on the card for
    a call :func:`norm_matmul_admits` admits."""
    h, n = w.shape
    rows = x.numel() // h if h else 0
    transposed, ldw = _w_layout(w)
    x2 = x.reshape(-1, h)
    return "stream" if fd_route(
        transposed, rows, n, h, ldw, x.dtype,
        _aligned(w) and x2.is_contiguous() and _aligned(x2)) \
        else "generic"


def norm_mlp_route(x, w1, w2, w_gate=None) -> str:
    """``"stream"`` (both launches on the stream kernel) or
    ``"generic"`` (both on the generic GEMV): the route K6c takes on the
    card for a call :func:`norm_mlp_admits` admits."""
    b, h = x.shape
    inter, out_dim = w1.shape[1], w2.shape[1]
    ok = _aligned(x, w1, w2, w_gate) and x.is_contiguous()
    ups = (w1,) if w_gate is None else (w1, w_gate)
    ok = ok and all(fd_route(False, b, inter, h, w.stride(0), x.dtype, True)
                    for w in ups)
    ok = ok and fd_route(False, b, out_dim, inter, w2.stride(0), x.dtype,
                         True)
    return "stream" if ok else "generic"


@functools.lru_cache(maxsize=None)   # a decode step asks the same every layer
def qkv_route(rows: int, nq: int, nk: int, k: int, ldq: int, ldk: int,
              ldv: int, head_dim: int, neox_rope: bool, dtype,
              aligned: bool) -> int:
    """Twin of ``csrc/fused_decode.cu``'s ``fd_qkv_route``: 1 where K6a's
    stream form takes ``rows`` rows against q/k/v weights of ``nq`` /
    ``nk`` / ``nk`` columns over ``k`` (row strides ``ldq`` / ``ldk`` /
    ``ldv``), 0 where the generic GEMV does.  The form takes 1..8 rows
    where each product is on :func:`fd_route`'s rule, a neox rotation's
    column pairs ``(j, j + hd/2)`` lie inside one tile (``hd`` divides its
    512 bytes of columns) and the window of x's rows over all of K fits
    beside a 3-stage ring."""
    if dtype not in _DTYPE_CODE:
        return 0
    item = dtype.itemsize
    tn, ks = stream_geometry(False, item)
    ksteps = -(-k // ks)
    window = _QKV_MAX_ROWS * (ksteps * ks * item
                              + (16 if dtype == torch.bfloat16 else 0))
    return int(1 <= rows <= _QKV_MAX_ROWS and head_dim > 0
               and head_dim % 2 == 0
               and (not neox_rope or tn % head_dim == 0)
               and all(fd_route(False, rows, n, k, ld, dtype, aligned)
                       for n, ld in ((nq, ldq), (nk, ldk), (nk, ldv)))
               and window + 3 * _STAGE_ROWS * _SEG_BYTES <= _SMEM_BUDGET)


def rope_qkv_route(x, wq, wk, wv, head_dim: int, neox: bool) -> str:
    """``"stream"`` or ``"generic"``: the route K6a takes on the card for
    a call :func:`rope_qkv_admits` admits (``neox``: a neox rotation is
    applied; without cos/sin pass False)."""
    b, h = x.shape
    return "stream" if qkv_route(
        b, wq.shape[1], wk.shape[1], h, wq.stride(0), wk.stride(0),
        wv.stride(0), head_dim, neox, x.dtype,
        x.is_contiguous() and _aligned(x, wq, wk, wv)) else "generic"


def stream_geometry(transposed: bool, itemsize: int):
    """(tile columns, K per step) of the stream kernel: 32 stage rows of
    512 bytes, a row-major weight's rows along K and a transposed one's
    along the columns."""
    if transposed:
        return _STAGE_ROWS, _SEG_BYTES // itemsize
    return 32 * (16 // itemsize), _STAGE_ROWS


class StreamPlan(NamedTuple):
    """Block j of ``grid`` takes units ``[j q + min(j, r), ... + q + (j <
    r))`` of the ``tiles x ksteps`` (tile, step) units, tile-major."""
    grid: int
    q: int
    r: int
    tiles: int
    ksteps: int


def stream_plan(tiles: int, ksteps: int, blocks: int) -> StreamPlan:
    """Deal the units out to at most ``blocks`` blocks (the ones the card
    holds at once), each at least one unit, shares differing by at most
    one."""
    units = tiles * ksteps
    if units < 1 or blocks < 1:
        raise ValueError(f"no units ({tiles} x {ksteps}) or blocks "
                         f"({blocks})")
    grid = min(blocks, units)
    q, r = divmod(units, grid)
    return StreamPlan(grid, q, r, tiles, ksteps)


def stream_shares(plan: StreamPlan):
    """[(first unit, end unit)] of every block."""
    out = []
    for j in range(plan.grid):
        start = j * plan.q + min(j, plan.r)
        out.append((start, start + plan.q + (j < plan.r)))
    return out


def _block_of(plan: StreamPlan, unit: int) -> int:
    big = plan.r * (plan.q + 1)
    return unit // (plan.q + 1) if unit < big \
        else plan.r + (unit - big) // plan.q


def stream_contributors(plan: StreamPlan, tile: int):
    """[(block, slot)] of the blocks whose shares cut ``tile``, in block
    order: the order their fp32 parts are added in.  Slot 0 is a block's
    first tile, 1 its last."""
    lo, hi = tile * plan.ksteps, (tile + 1) * plan.ksteps
    out = []
    for j in range(_block_of(plan, lo), _block_of(plan, hi - 1) + 1):
        start = j * plan.q + min(j, plan.r)
        out.append((j, 0 if start // plan.ksteps == tile else 1))
    return out


# ---------------------------------------------------------------------------
# the CUDA route
# ---------------------------------------------------------------------------

_sm_count = {}
_counters = {}


def _splits(blocks: int, k: int, dev) -> int:
    """grid.z of a GEMV: split K while the columns alone fill fewer than
    two blocks per SM, each split keeping at least 512 rows."""
    sms = _sm_count.get(dev)
    if sms is None:
        sms = _sm_count[dev] = \
            torch.cuda.get_device_properties(dev).multi_processor_count
    target = 2 * sms
    if blocks >= target:
        return 1
    return max(1, min(-(-target // blocks), k // _MIN_SPLIT_K))


def _tiles(n: int) -> int:
    return -(-(-(-n // 2)) // _TILE_PAIRS)


def _tile_counters(dev, n_tiles: int):
    """Zeroed tile counters.  The kernels leave every counter they used
    at 0, so one buffer per device serves every launch on its stream."""
    cnt = _counters.get(dev)
    if cnt is None or cnt.numel() < n_tiles:
        cnt = _counters[dev] = torch.zeros(max(n_tiles, 4096),
                                           dtype=torch.int32, device=dev)
    return cnt


def _scratch(dev, tiles: int, rows: int, splits: int):
    """(partial sums, zeroed tile counters) for a split-K GEMV."""
    n_tiles = tiles * -(-rows // _ROWS)
    partial = torch.empty(n_tiles * splits * 2 * _THREADS
                          if splits > 1 else 1, dtype=torch.float32,
                          device=dev)
    return partial, _tile_counters(dev, n_tiles)


_occupancy = {}


def _stream_blocks(dev, kind: int, transposed: bool, rows: int, gated: bool,
                   dtype, tiles: int, ksteps: int) -> int:
    """The stream kernel's blocks the card holds at once for one launch:
    the SM count times the occupancy of the form the launch takes (asked
    of the kernel's C side once per shape)."""
    key = (dev, kind, bool(transposed), rows, bool(gated), dtype, tiles,
           ksteps)
    per_sm = _occupancy.get(key)
    if per_sm is None:
        lib = _build.library("fused_decode")
        with torch.cuda.device(dev):
            per_sm = lib.fd_stream_occupancy(kind, int(bool(transposed)),
                                             rows, int(bool(gated)),
                                             _DTYPE_CODE[dtype], tiles,
                                             ksteps)
        if per_sm < 1:
            raise RuntimeError(f"stream kernel occupancy: CUDA error "
                               f"{-per_sm}")
        _occupancy[key] = per_sm
    sms = _sm_count.get(dev)
    if sms is None:
        sms = _sm_count[dev] = \
            torch.cuda.get_device_properties(dev).multi_processor_count
    return per_sm * sms


_plans = {}


def _work_floats(plan: StreamPlan, rows: int, tn: int) -> int:
    """fp32 parts a launch may leave: two tiles a block, or (the resident
    row-major form) every warp's part of every tile a share touches."""
    slots = -(-(plan.q + 1) // plan.ksteps) + 1
    return plan.grid * rows * tn * max(2, 8 * slots)


def _plan_for(dev, kind, transposed, rows, gated, dtype, n_tiles, k):
    """(tile columns, the launch's plan), kept per shape: a decode step
    asks for the same few every layer."""
    tn, ks = stream_geometry(transposed, dtype.itemsize)
    tiles, ksteps = n_tiles(tn), -(-k // ks)
    key = (dev, kind, bool(transposed), rows, bool(gated), dtype, tiles,
           ksteps)
    plan = _plans.get(key)
    if plan is None:
        plan = _plans[key] = stream_plan(tiles, ksteps, _stream_blocks(
            dev, kind, transposed, rows, gated, dtype, tiles, ksteps))
    return tn, plan


def _f32(t):
    return None if t is None else t.to(torch.float32).contiguous()


def _ptr(t):
    return None if t is None else t.data_ptr()


def _same_device(dev, named):
    for name, t in named.items():
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")


def _rc(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def _rope_qkv_cuda(x, wq, wk, wv, bq, bk, bv, cos_row, sin_row, n_heads,
                   n_kv, head_dim, neox):
    dev = x.device
    _same_device(dev, dict(wq=wq, wk=wk, wv=wv, bq=bq, bk=bk, bv=bv,
                           cos_row=cos_row, sin_row=sin_row))
    b, h = x.shape
    nq, nk = n_heads * head_dim, n_kv * head_dim
    if tuple(wq.shape) != (h, nq) or tuple(wk.shape) != (h, nk) \
            or tuple(wv.shape) != (h, nk):
        raise ValueError(f"weights {tuple(wq.shape)}, {tuple(wk.shape)}, "
                         f"{tuple(wv.shape)} do not match x [{b}, {h}] and "
                         f"{n_heads}/{n_kv} heads of {head_dim}")
    for name, t, n in (("bq", bq, nq), ("bk", bk, nk), ("bv", bv, nk)):
        if t is not None and tuple(t.shape) != (n,):
            raise ValueError(f"{name} must be [{n}], got {tuple(t.shape)}")
    if (cos_row is None) != (sin_row is None):
        raise ValueError("cos_row and sin_row come together")
    if cos_row is not None and (tuple(cos_row.shape) != (head_dim,)
                                or tuple(sin_row.shape) != (head_dim,)):
        raise ValueError(f"cos_row/sin_row must be [{head_dim}]")
    x = x.contiguous()
    q = torch.empty((b, nq), dtype=x.dtype, device=dev)
    k = torch.empty((b, nk), dtype=x.dtype, device=dev)
    v = torch.empty((b, nk), dtype=x.dtype, device=dev)
    if b:
        neox = bool(neox) and cos_row is not None
        bq, bk, bv, cos_row, sin_row = (_f32(t) for t in
                                        (bq, bk, bv, cos_row, sin_row))
        lib = _build.library("fused_decode")
        px, pq, pk, pv = (x.data_ptr(), wq.data_ptr(), wk.data_ptr(),
                          wv.data_ptr())
        ldq, ldk, ldv = wq.stride(0), wk.stride(0), wv.stride(0)
        common = (px, b, h, pq, pk, pv, ldq, ldk, ldv, _ptr(bq), _ptr(bk),
                  _ptr(bv), _ptr(cos_row), _ptr(sin_row), int(neox),
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), nq, nk, head_dim)
        stream = torch.cuda.current_stream(dev).cuda_stream
        # rope_qkv_route's rule on what is read here already (a decode
        # step's loop is host-bound: each call's microseconds count)
        if qkv_route(b, nq, nk, h, ldq, ldk, ldv, head_dim, neox, x.dtype,
                     (px | pq | pk | pv) % 16 == 0):
            tn, plan = _plan_for(dev, _K6A, False, b, False, x.dtype,
                                 lambda tn: -(-nq // tn) + 2 * -(-nk // tn),
                                 h)
            slots = -(-(plan.q + 1) // plan.ksteps) + 1
            work = torch.empty(plan.grid * slots * b * tn,
                               dtype=torch.float32, device=dev)
            with torch.cuda.device(dev):
                rc = lib.fd_rope_qkv_stream(
                    *common, work.data_ptr(), plan.grid, plan.q, plan.r,
                    _DTYPE_CODE[x.dtype], stream)
        else:
            tiles = _tiles(nq) + 2 * _tiles(nk)
            splits = _splits(tiles * -(-b // _ROWS), h, dev)
            partial, cnt = _scratch(dev, tiles, b, splits)
            with torch.cuda.device(dev):
                rc = lib.fd_rope_qkv(
                    *common, partial.data_ptr(), cnt.data_ptr(), splits,
                    _DTYPE_CODE[x.dtype], stream)
        _rc(rc, "rope_qkv")
        launches["rope_qkv"] += 1
    return (q.view(b, n_heads, head_dim), k.view(b, n_kv, head_dim),
            v.view(b, n_kv, head_dim))


def rope_qkv(x, wq, wk, wv, bq=None, bk=None, bv=None, cos_row=None,
             sin_row=None, *, n_heads, n_kv, head_dim, neox=False):
    """The q/k/v projections (+ optional rotary embedding) of one decode
    token per row.  ``x [B, H]``; ``w* [H, n*hd]`` (``[in, out]``, any
    row stride); ``cos/sin [hd]`` (None: no rope — GPT's learned
    positions live in the embedding).  Returns ``(q [B, nh, hd],
    k [B, nkv, hd], v [B, nkv, hd])``, in x's dtype on the kernel route.
    """
    kw = dict(n_heads=n_heads, n_kv=n_kv, head_dim=head_dim, neox=neox)
    if x.device.type == "cpu":
        return rope_qkv_ref(x, wq, wk, wv, bq, bk, bv, cos_row, sin_row,
                            **kw)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not rope_qkv_admits(x, wq, wk, wv, n_heads, n_kv, head_dim):
        return rope_qkv_ref(x, wq, wk, wv, bq, bk, bv, cos_row, sin_row,
                            **kw)
    return _rope_qkv_cuda(x, wq, wk, wv, bq, bk, bv, cos_row, sin_row,
                          n_heads, n_kv, head_dim, neox)


def _attend_cuda(q, k_new, v_new, k_cache, v_cache, pos, scale):
    dev = q.device
    _same_device(dev, dict(k_new=k_new, v_new=v_new, k_cache=k_cache,
                           v_cache=v_cache))
    b, nh, hd = q.shape
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape \
            or k_cache.shape[0] != b or k_cache.shape[3] != hd:
        raise ValueError(f"caches {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)} must be [{b}, S_total, "
                         f"nkv, {hd}]")
    st, nkv = k_cache.shape[1], k_cache.shape[2]
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if tuple(t.shape) != (b, nkv, hd):
            raise ValueError(f"{name} must be [{b}, {nkv}, {hd}], got "
                             f"{tuple(t.shape)}")
    if not 0 <= pos < st:
        raise ValueError(f"pos {pos} outside the cache's {st} rows")
    q = q.contiguous()
    k_new = k_new.to(k_cache.dtype).contiguous()
    v_new = v_new.to(v_cache.dtype).contiguous()
    ctx = torch.empty_like(q)
    if b:
        lib = _build.library("fused_decode")
        with torch.cuda.device(dev):
            rc = lib.fd_attend(
                q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                k_cache.data_ptr(), v_cache.data_ptr(), ctx.data_ptr(), b,
                nh, nkv, hd, st, pos, float(scale), _DTYPE_CODE[q.dtype],
                torch.cuda.current_stream().cuda_stream)
        _rc(rc, "attend_cache_append")
        launches["attend_cache_append"] += 1
    return ctx, k_cache, v_cache


def attend_cache_append(q, k_new, v_new, k_cache, v_cache, pos,
                        scale=None):
    """Append one token's k/v to the preallocated caches at ``pos`` and
    attend ``q`` to positions ``0..pos``.

    ``q [B, nh, hd]``; ``k_new/v_new [B, nkv, hd]``; caches ``[B,
    S_total, nkv, hd]``, **updated in place**; ``pos`` a host int shared
    by the batch.  Returns ``(ctx [B, nh, hd], k_cache, v_cache)`` — the
    caches are the tensors passed in."""
    pos = int(pos)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return attend_cache_append_ref(q, k_new, v_new, k_cache, v_cache,
                                       pos, scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if not attend_admits(q, k_cache, v_cache):
        return attend_cache_append_ref(q, k_new, v_new, k_cache, v_cache,
                                       pos, scale)
    return _attend_cuda(q, k_new, v_new, k_cache, v_cache, pos, scale)


def _norm_mlp_cuda(x, kind, norm_w, norm_b, w1, b1, w2, b2, w_gate, eps,
                   act):
    dev = x.device
    _same_device(dev, dict(norm_w=norm_w, norm_b=norm_b, w1=w1, b1=b1, w2=w2,
                           b2=b2, w_gate=w_gate))
    b, h = x.shape
    inter, out_dim = w1.shape[1], w2.shape[1]
    if w1.shape[0] != h or w2.shape[0] != inter or (
            w_gate is not None and tuple(w_gate.shape) != tuple(w1.shape)):
        raise ValueError(f"weights w1 {tuple(w1.shape)}, w2 "
                         f"{tuple(w2.shape)}, w_gate "
                         f"{None if w_gate is None else tuple(w_gate.shape)}"
                         f" do not chain from x [{b}, {h}]")
    for name, t, n in (("norm_w", norm_w, h), ("norm_b", norm_b, h),
                       ("b1", b1, inter), ("b2", b2, out_dim)):
        if t is not None and tuple(t.shape) != (n,):
            raise ValueError(f"{name} must be [{n}], got {tuple(t.shape)}")
    if kind == "layer_norm":
        act_code = _GELU_TANH if act == "gelu_tanh" else _GELU
    else:
        if w_gate is None:
            raise ValueError("kind='rms_norm' needs w_gate")
        act_code = _GELU_TANH if act == "gelu_tanh" else _SILU
    x = x.contiguous()
    y = torch.empty((b, out_dim), dtype=x.dtype, device=dev)
    if not b:
        return y
    n_up = 1 if w_gate is None else 2      # up (and gate) products
    stream = norm_mlp_route(x, w1, w2, w_gate) == "stream"
    # the stream route's scratch holds either layout (csrc: fd_norm_mlp_stream)
    scratch = torch.empty(max(24 * inter + 8 * h, n_up * b * inter) if stream
                          else n_up * b * inter, dtype=torch.float32,
                          device=dev)
    norm_w, norm_b, b1, b2 = (_f32(t) for t in (norm_w, norm_b, b1, b2))
    lib = _build.library("fused_decode")
    common = (x.data_ptr(), b, h, norm_w.data_ptr(), _ptr(norm_b),
              _NORM_CODE[kind], float(eps), w1.data_ptr(), w1.stride(0),
              _ptr(w_gate), 0 if w_gate is None else w_gate.stride(0),
              _ptr(b1), act_code, w2.data_ptr(), w2.stride(0), _ptr(b2),
              scratch.data_ptr(), y.data_ptr(), inter, out_dim)
    if stream:
        tn, up = _plan_for(dev, _K6C_UP, False, b, False, x.dtype,
                           lambda tn: n_up * -(-inter // tn), h)
        _, down = _plan_for(dev, _K6C_DOWN, False, b, w_gate is not None,
                            x.dtype, lambda tn: -(-out_dim // tn), inter)
        work = torch.empty(max(_work_floats(up, b, tn),
                               _work_floats(down, b, tn)),
                           dtype=torch.float32, device=dev)
        # the up launch's tiles, then its column tiles' up/gate pairs
        cnt = _tile_counters(dev, max(up.tiles + -(-inter // tn), down.tiles))
        with torch.cuda.device(dev):
            rc = lib.fd_norm_mlp_stream(
                *common, work.data_ptr(), cnt.data_ptr(), up.grid, up.q,
                up.r, down.grid, down.q, down.r, _DTYPE_CODE[x.dtype],
                torch.cuda.current_stream().cuda_stream)
    else:
        y_tiles = -(-b // _ROWS)
        t_up, t_down = n_up * _tiles(inter), _tiles(out_dim)
        s_up = _splits(t_up * y_tiles, h, dev)
        s_down = _splits(t_down * y_tiles, inter, dev)
        partial, cnt = _scratch(dev, max(t_up, t_down), b,
                                max(s_up, s_down))
        with torch.cuda.device(dev):
            rc = lib.fd_norm_mlp(
                *common, partial.data_ptr(), cnt.data_ptr(), s_up, s_down,
                _DTYPE_CODE[x.dtype], torch.cuda.current_stream().cuda_stream)
    _rc(rc, "norm_mlp")
    launches["norm_mlp"] += 1
    return y


def norm_mlp(x, *, kind, norm_w, norm_b=None, w1, b1=None, w2, b2=None,
             w_gate=None, eps=1e-5, act="silu"):
    """Norm + MLP tail of one decoder block on ``x [N, H]`` (``[in, out]``
    weights): ``kind="layer_norm"`` LayerNorm -> ``w1``/``b1`` -> gelu
    (tanh for ``act="gelu_tanh"``, else exact) -> ``w2``/``b2`` (GPT);
    ``kind="rms_norm"`` RMSNorm -> ``act(h @ w_gate) * (h @ w1)`` ->
    ``w2`` (LLaMA; silu, or gelu_tanh).  The residual add stays with the
    caller."""
    if kind not in _NORM_CODE:
        raise ValueError(f"unknown norm kind {kind!r}")
    kw = dict(kind=kind, norm_w=norm_w, norm_b=norm_b, w1=w1, b1=b1, w2=w2,
              b2=b2, w_gate=w_gate, eps=eps, act=act)
    if x.device.type == "cpu":
        return norm_mlp_ref(x, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not norm_mlp_admits(x, w1, w2, w_gate):
        return norm_mlp_ref(x, **kw)
    return _norm_mlp_cuda(x, kind, norm_w, norm_b, w1, b1, w2, b2, w_gate,
                          eps, act)


def _norm_matmul_cuda(x, norm_w, norm_b, w, bias, kind, eps):
    dev = x.device
    _same_device(dev, dict(norm_w=norm_w, norm_b=norm_b, w=w, bias=bias))
    h, n = w.shape
    if x.shape[-1] != h:
        raise ValueError(f"x [..., {x.shape[-1]}] does not match w "
                         f"{tuple(w.shape)}")
    for name, t, size in (("norm_w", norm_w, h), ("norm_b", norm_b, h),
                          ("bias", bias, n)):
        if t is not None and tuple(t.shape) != (size,):
            raise ValueError(f"{name} must be [{size}], got "
                             f"{tuple(t.shape)}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, h).contiguous()
    b = x2.shape[0]
    y = torch.empty((b, n), dtype=x.dtype, device=dev)
    if b and n:
        transposed, ldw = _w_layout(w)
        norm_w, norm_b, bias = (_f32(t) for t in (norm_w, norm_b, bias))
        lib = _build.library("fused_decode")
        common = (x2.data_ptr(), b, h, norm_w.data_ptr(), _ptr(norm_b),
                  _NORM_CODE[kind], float(eps), w.data_ptr(), ldw,
                  transposed, _ptr(bias), y.data_ptr(), n)
        stream = torch.cuda.current_stream(dev).cuda_stream
        if norm_matmul_route(x2, w) == "stream":
            tn, plan = _plan_for(dev, _K6D, transposed, b, False, x.dtype,
                                 lambda tn: -(-n // tn), h)
            work = torch.empty(_work_floats(plan, b, tn),
                               dtype=torch.float32, device=dev)
            cnt = _tile_counters(dev, plan.tiles)
            # x's normalized rows, where the resident form (<= 8 rows) runs
            xbuf = torch.empty(8 * h if b <= 8 else 1, dtype=torch.float32,
                               device=dev)
            with torch.cuda.device(dev):
                rc = lib.fd_norm_matmul_stream(
                    *common, work.data_ptr(), cnt.data_ptr(),
                    xbuf.data_ptr(), plan.grid, plan.q, plan.r,
                    _DTYPE_CODE[x.dtype], stream)
        else:
            splits, partial, cnt = 1, None, None
            if not transposed:
                tiles = _tiles(n)
                splits = _splits(tiles * -(-b // _ROWS), h, dev)
                partial, cnt = _scratch(dev, tiles, b, splits)
            with torch.cuda.device(dev):
                rc = lib.fd_norm_matmul(
                    *common, _ptr(partial), _ptr(cnt), splits,
                    _DTYPE_CODE[x.dtype], stream)
        _rc(rc, "norm_matmul")
        launches["norm_matmul"] += 1
    return y.reshape(*lead, n)


def norm_matmul(x, norm_w, norm_b, w, bias=None, *, kind="rms_norm",
                eps=1e-6):
    """``matmul(norm(x), w) (+ bias)`` over ``x [..., H]`` with ``w [H,
    N]`` (a ``transpose_y`` weight as a transposed view).  ``kind``
    ``"layer_norm"`` (``norm_w``, optional ``norm_b``) or ``"rms_norm"``
    (``norm_w``; ``norm_b`` is not read).  Returns ``[..., N]`` in x's
    dtype (the bias's promotion on the plain route)."""
    if kind not in _NORM_CODE:
        raise ValueError(f"unknown norm kind {kind!r}")
    if kind == "rms_norm":
        norm_b = None
    if x.device.type == "cpu":
        return norm_matmul_ref(x, norm_w, norm_b, w, bias, kind=kind,
                               eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not norm_matmul_admits(x, w, bias):
        return norm_matmul_ref(x, norm_w, norm_b, w, bias, kind=kind,
                               eps=eps)
    return _norm_matmul_cuda(x, norm_w, norm_b, w, bias, kind, eps)


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    lib.fd_rope_qkv.argtypes = [p, i, i, p, p, p, ll, ll, ll, p, p, p, p, p,
                                i, p, p, p, i, i, i, p, p, i, i, p]
    lib.fd_rope_qkv.restype = ctypes.c_int
    lib.fd_attend.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, f, i, p]
    lib.fd_attend.restype = ctypes.c_int
    lib.fd_norm_mlp.argtypes = [p, i, i, p, p, i, f, p, ll, p, ll, p, i, p,
                                ll, p, p, p, i, i, p, p, i, i, i, p]
    lib.fd_norm_mlp.restype = ctypes.c_int
    lib.fd_norm_matmul.argtypes = [p, i, i, p, p, i, f, p, ll, i, p, p, i,
                                   p, p, i, i, p]
    lib.fd_norm_matmul.restype = ctypes.c_int
    # the stream route (absent from a variant built from an older source)
    if hasattr(lib, "fd_route"):
        lib.fd_route.argtypes = [i, i, i, i, ll, i, i]
        lib.fd_route.restype = ctypes.c_int
        lib.fd_stream_occupancy.argtypes = [i, i, i, i, i, i, i]
        lib.fd_stream_occupancy.restype = ctypes.c_int
        lib.fd_norm_matmul_stream.argtypes = [p, i, i, p, p, i, f, p, ll, i,
                                              p, p, i, p, p, p, i, i, i, i,
                                              p]
        lib.fd_norm_matmul_stream.restype = ctypes.c_int
        lib.fd_norm_mlp_stream.argtypes = [p, i, i, p, p, i, f, p, ll, p, ll,
                                           p, i, p, ll, p, p, p, i, i, p, p,
                                           i, i, i, i, i, i, i, p]
        lib.fd_norm_mlp_stream.restype = ctypes.c_int
    # K6a's stream form (absent from a variant built from an older source)
    if hasattr(lib, "fd_qkv_route"):
        lib.fd_qkv_route.argtypes = [i, i, i, i, ll, ll, ll, i, i, i, i]
        lib.fd_qkv_route.restype = ctypes.c_int
        lib.fd_rope_qkv_stream.argtypes = [p, i, i, p, p, p, ll, ll, ll, p, p,
                                           p, p, p, i, p, p, p, i, i, i, p, i,
                                           i, i, i, p]
        lib.fd_rope_qkv_stream.restype = ctypes.c_int


_build.register("fused_decode", _declare)
