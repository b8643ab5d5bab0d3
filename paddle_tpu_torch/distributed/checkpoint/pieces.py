"""What a rank holds of each global tensor, and how two layouts overlap.

A **piece** is this rank's part of one global tensor of a checkpoint
(key, global shape, dtype):

* its *local tensor* (shape ``lshape``) is the concatenation along
  ``axis`` of one or more **boxes** of the global tensor (``(offsets,
  lengths)``): one box for a whole tensor, one for an mp shard, three
  for a packed ``[q | k | v]`` shard (``split_groups`` 3);
* of that local tensor the rank may hold only the flat range ``[lo,
  hi)`` of its row-major order: a ZeRO shard of a flat bucket cuts
  through parameters, even through a row;
* ``data`` is what the rank holds, 1-D, ``hi - lo`` elements: a live
  view (a parameter, an optimizer state shard), so a load writes in
  place.

:func:`chunks` cuts a piece into blocks that are each contiguous in its
data and lie inside one global box; two layouts overlap block by block
(:func:`overlaps`), which is how a load reads, for each piece a rank
holds now, the parts of the saved pieces it needs.

The hooks that list pieces live beside the state they describe:
``mp_layers._checkpoint_layout`` (the boxes of a split parameter),
``parallel._ShardedReducer._checkpoint_pieces`` (ZeRO stage 3's flat
shards), ``Optimizer._checkpoint_pieces`` and
``DygraphShardingOptimizer._checkpoint_pieces`` (the accumulators, by
the parameter's structured name).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Piece", "chunks", "overlaps", "whole", "piece", "block_view",
           "dtype_name", "torch_dtype", "numpy_dtype"]

Box = Tuple[Tuple[int, ...], Tuple[int, ...]]

_DTYPES = {str(d).split(".")[1]: d for d in (
    torch.float32, torch.float64, torch.float16, torch.bfloat16,
    torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
    torch.bool)}
# numpy holds a bf16 tensor's words as uint16
_NUMPY = {"float32": np.float32, "float64": np.float64,
          "float16": np.float16, "bfloat16": np.uint16, "int64": np.int64,
          "int32": np.int32, "int16": np.int16, "int8": np.int8,
          "uint8": np.uint8, "bool": np.bool_}


def dtype_name(dtype: torch.dtype) -> str:
    name = str(dtype).split(".")[1]
    if name not in _DTYPES:
        raise TypeError(f"checkpoint: dtype {dtype} is not supported")
    return name


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def numpy_dtype(name: str):
    return _NUMPY[name]


@dataclass
class Piece:
    key: str
    gshape: Tuple[int, ...]
    dtype: str
    lshape: Tuple[int, ...]
    axis: int
    boxes: Tuple[Box, ...]
    lo: int
    hi: int
    data: Optional[torch.Tensor] = None

    @property
    def numel(self) -> int:
        return self.hi - self.lo

    @property
    def nbytes(self) -> int:
        return self.numel * torch_dtype(self.dtype).itemsize

    def desc(self) -> dict:
        """The piece without its data (JSON-able; what the ranks gather
        and the metadata file records)."""
        return {"key": self.key, "gshape": list(self.gshape),
                "dtype": self.dtype, "lshape": list(self.lshape),
                "axis": self.axis,
                "boxes": [[list(o), list(n)] for o, n in self.boxes],
                "lo": self.lo, "hi": self.hi}

    @staticmethod
    def from_desc(d: dict) -> "Piece":
        return Piece(d["key"], tuple(d["gshape"]), d["dtype"],
                     tuple(d["lshape"]), int(d["axis"]),
                     tuple((tuple(o), tuple(n)) for o, n in d["boxes"]),
                     int(d["lo"]), int(d["hi"]))


def whole(key: str, t: torch.Tensor) -> Piece:
    """A tensor held whole (replicated, or a plain model's)."""
    shape = tuple(t.shape)
    return Piece(key, shape, dtype_name(t.dtype), shape, 0,
                 (((0,) * len(shape), shape),), 0, t.numel(),
                 t.reshape(-1) if t.numel() else t.reshape(0))


def piece(key: str, data: torch.Tensor, lshape, gshape, axis: int, boxes,
          lo: int = 0, hi: Optional[int] = None) -> Piece:
    """A piece from its parts; ``data`` is the ``[lo, hi)`` range of the
    local tensor (default: all of it), flattened."""
    lshape = tuple(int(s) for s in lshape)
    hi = math.prod(lshape) if hi is None else int(hi)
    return Piece(key, tuple(int(s) for s in gshape), dtype_name(data.dtype),
                 lshape, int(axis),
                 tuple((tuple(int(v) for v in o), tuple(int(v) for v in n))
                       for o, n in boxes), int(lo), hi, data.reshape(-1))


def _range_boxes(shape: Sequence[int], lo: int, hi: int) -> List[Box]:
    """The flat range ``[lo, hi)`` of a row-major ``shape`` as boxes in
    order, each contiguous in that order (a partial row, whole rows, a
    partial row; recursively)."""
    if lo >= hi:
        return []
    if not shape:
        return [((), ())]
    inner = math.prod(shape[1:])
    rest = tuple(shape[1:])
    a, ra = divmod(lo, inner)
    b, rb = divmod(hi, inner)
    if a == b:
        return [((a,) + o, (1,) + n) for o, n in _range_boxes(rest, ra, rb)]
    out = []
    if ra:
        out += [((a,) + o, (1,) + n)
                for o, n in _range_boxes(rest, ra, inner)]
        a += 1
    if b > a:
        out.append(((a,) + (0,) * len(rest), (b - a,) + rest))
    if rb:
        out += [((b,) + o, (1,) + n) for o, n in _range_boxes(rest, 0, rb)]
    return out


def chunks(p: Piece):
    """``(goff, glen, start, bshape, bslice)`` blocks of ``p``: the
    block of ``p.data[start:start + prod(bshape)]`` viewed as ``bshape``
    and cut by ``bslice`` is the global box ``(goff, glen)``."""
    out = []
    # where each box starts along the axis of the local tensor
    starts, c = [], 0
    for o, n in p.boxes:
        starts.append(c)
        c += n[p.axis] if n else 1
    start = 0
    for loff, llen in _range_boxes(p.lshape, p.lo, p.hi):
        size = math.prod(llen)
        if not p.lshape:                       # a scalar
            out.append(((), (), start, (), ()))
            start += size
            continue
        ax = p.axis
        a0, a1 = loff[ax], loff[ax] + llen[ax]
        for (bo, bn), s0 in zip(p.boxes, starts):
            s, e = max(a0, s0), min(a1, s0 + bn[ax])
            if s >= e:
                continue
            goff = tuple(bo[d] + (s - s0 if d == ax else loff[d])
                         for d in range(len(loff)))
            glen = tuple(e - s if d == ax else llen[d]
                         for d in range(len(llen)))
            bsl = tuple(slice(s - a0, e - a0) if d == ax else slice(None)
                        for d in range(len(llen)))
            out.append((goff, glen, start, tuple(llen), bsl))
        start += size
    return out


def overlaps(dst_chunks, src_chunks):
    """``(dst_chunk, src_chunk, dst_region, src_region)`` for every pair
    of blocks whose global boxes intersect (regions: slices of each
    block after its own ``bslice``)."""
    for dc in dst_chunks:
        doff, dlen = dc[0], dc[1]
        for sc in src_chunks:
            soff, slen = sc[0], sc[1]
            lo = [max(a, b) for a, b in zip(doff, soff)]
            hi = [min(a + n, b + m) for a, n, b, m in
                  zip(doff, dlen, soff, slen)]
            if any(h <= l for l, h in zip(lo, hi)):
                continue
            dreg = tuple(slice(l - o, h - o) for l, h, o in zip(lo, hi, doff))
            sreg = tuple(slice(l - o, h - o) for l, h, o in zip(lo, hi, soff))
            yield dc, sc, dreg, sreg


def block_view(data: torch.Tensor, chunk) -> torch.Tensor:
    """The torch view of ``chunk`` in a piece's 1-D ``data``."""
    _, _, start, bshape, bsl = chunk
    n = math.prod(bshape)
    return data[start:start + n].view(bshape)[bsl]
