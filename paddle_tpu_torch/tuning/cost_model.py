"""The analytic cost terms the learned perf model (``tuning.learned``)
builds its feature dicts from; the part of
``paddle_tpu/tuning/cost_model.py`` that ``learned.py`` and
``analysis.perf_features`` import: ``Coefficients``, ``flash_features``,
``_flash_cost``, ``_plan_cost``, ``dtype_bytes`` and the op-class
vocabulary (``classify_primitive``).

The ``Coefficients`` defaults are the JAX package's own (its TPU
datasheet constants), kept unchanged so the ``flash`` and ``plan``
heads' analytic-prior features equal the reference's on the same
inputs.  They describe no property of the H100: the port's serving path
reads only the ``batch_step`` head, whose features are the event log's
batch composition and whose targets are the port's own measured step
times.  ``Engine.tune`` orders its (dp, sharding, mp) candidates with
``rank_plans`` (``CostModel.rank_plans``: ``_plan_cost``, for ordering
only, measurement decides) and stores ``plan_layout`` in its plan cache
entries.  ``CostModel``'s flash-block ranking and fit,
``features_from_jaxpr`` and the sanity gate are not ported.

Stdlib-only.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence

MXU_TILE = 128          # the reference's matrix-unit tile

_DTYPE_BYTES = {
    "float64": 8, "complex64": 8, "int64": 8, "uint64": 8,
    "float32": 4, "int32": 4, "uint32": 4,
    "bfloat16": 2, "float16": 2, "int16": 2, "uint16": 2,
    "int8": 1, "uint8": 1, "bool": 1,
    "float8_e4m3fn": 1, "float8_e5m2": 1,
}


def dtype_bytes(dtype) -> int:
    name = str(dtype)
    for key, nbytes in _DTYPE_BYTES.items():
        if key in name:
            return nbytes
    return 4


@dataclass
class Coefficients:
    """Hardware + overhead constants of the JAX package's analytic model
    (its TPU datasheet numbers, kept so the prior features equal the
    reference's — not the H100's); ``alpha_*`` are its fit-refinable
    multipliers (identity here)."""
    peak_flops: float = 197e12        # bf16 MXU peak
    hbm_bytes_per_s: float = 819e9
    grid_overhead_s: float = 1.5e-6   # per grid-step dispatch
    iter_overhead_s: float = 8e-8     # per inner fori_loop iteration
    vmem_budget_bytes: float = 0.75 * 16 * 2 ** 20
    vmem_penalty: float = 8.0         # over-budget blocks spill or fail
    ici_flops_per_byte: float = 240.0  # chip compute intensity vs ICI
    alpha_compute: float = 1.0
    alpha_memory: float = 1.0
    alpha_overhead: float = 1.0


# ---------------------------------------------------------------------------
# flash block candidates
# ---------------------------------------------------------------------------

def flash_features(sq: int, sk: int, d: int, dtype, causal: bool,
                   bq: int, bk: int, bh: int = 8) -> Dict[str, float]:
    """Feature vector for one flash launch with blocks (bq, bk).

    The kernel grid is (bh, sq/bq); each grid step fori-loops over
    sk/bk key blocks, streaming K/V from HBM, so a taller q block means
    fewer K/V re-streams while a wider k block means fewer loop
    iterations.  Causality drops ~half the key blocks (the lower block
    triangle: (1+n_k)/2 of n_k survive on average)."""
    nbytes = dtype_bytes(dtype)
    bq = max(1, min(bq, sq))
    bk = max(1, min(bk, sk))
    n_q = math.ceil(sq / bq)
    n_k = math.ceil(sk / bk)
    causal_frac = (1.0 + n_k) / (2.0 * n_k) if causal else 1.0
    flops = 4.0 * bh * sq * sk * d * causal_frac        # QK^T + PV
    # Q and O move once; K/V stream once per q-block row
    hbm_bytes = bh * nbytes * (2.0 * sq * d
                               + n_q * 2.0 * sk * d * causal_frac)
    # tile alignment: rows below the 128-lane MXU tile idle the array;
    # the contraction/value sides average the QK^T (bk cols) and PV
    # (d cols) matmuls
    row_util = min(bq, MXU_TILE) / MXU_TILE
    col_util = 0.5 * (min(bk, MXU_TILE) + min(d, MXU_TILE)) / MXU_TILE
    mxu_util = row_util * min(col_util, 1.0)
    grid_steps = float(bh * n_q)
    inner_iters = grid_steps * n_k * causal_frac
    # double-buffered streaming tiles + f32 scores/accumulator
    vmem_bytes = (2.0 * nbytes * (bq * d + 2.0 * bk * d)
                  + 4.0 * (bq * bk + 2.0 * bq * d))
    return {"flops": flops, "hbm_bytes": hbm_bytes, "mxu_util": mxu_util,
            "grid_steps": grid_steps, "inner_iters": inner_iters,
            "vmem_bytes": vmem_bytes, "dtype_bytes": float(nbytes)}


def _flash_cost(f: Dict[str, float], c: Coefficients) -> float:
    # f32 runs the MXU at half rate; sub-16-bit types don't go faster
    # than bf16 on the flash path (the accumulator is f32 anyway)
    peak = c.peak_flops * (2.0 / f["dtype_bytes"] if f["dtype_bytes"] > 2
                           else 1.0)
    util = max(f["mxu_util"], 1e-3)
    t_compute = f["flops"] / (peak * util)
    t_memory = f["hbm_bytes"] / c.hbm_bytes_per_s
    t_overhead = (f["grid_steps"] * c.grid_overhead_s
                  + f["inner_iters"] * c.iter_overhead_s)
    t = (max(c.alpha_compute * t_compute, c.alpha_memory * t_memory)
         + c.alpha_overhead * t_overhead)
    if f["vmem_bytes"] > c.vmem_budget_bytes:
        t *= c.vmem_penalty * (f["vmem_bytes"] / c.vmem_budget_bytes)
    return t


# ---------------------------------------------------------------------------
# (dp, sharding, mp) plans
# ---------------------------------------------------------------------------

def _plan_cost(candidate: Sequence[int], batch_tokens: int,
               param_bytes: int, c: Coefficients) -> float:
    """Roofline for one mesh factorization, in byte-equivalent time
    units (moved here from ``Engine._rank_candidates``): per-device
    compute is (~2·N·T FLOPs)/(shards · CI) with CI the chip's compute
    intensity per ICI byte; dp/sharding adds the ring grad all-reduce
    (2(n-1)/n of the mp-shard's param bytes); mp adds activation
    collectives (∝ this device's batch-token bytes per live mp hop).
    Model- and batch-size aware, for ORDERING only."""
    dp, sh, mp = candidate
    shards = max(dp * sh * mp, 1)
    t = (batch_tokens * param_bytes / 2.0) / (shards * c.ici_flops_per_byte)
    n = dp * sh
    if n > 1:
        t += 2.0 * (n - 1) / n * (param_bytes / mp)
    if mp > 1:
        t += 2.0 * (mp - 1) / mp * (4.0 * batch_tokens / n) * 8
    return t


def plan_layout(dp: int, sharding: int, mp: int) -> dict:
    """The layout table of a tuned plan, the JAX package's: the mesh's
    axis sizes and the spec each parameter / activation role gets, as
    axis-name lists (None: replicated on that dim)."""
    return {
        "mesh_axes": {"dp": dp, "sharding": sharding, "mp": mp},
        "specs": {
            "batch": ["dp", None],
            "embeddings": [["sharding", "mp"], None],
            "qkv_projection": ["sharding", "mp"],
            "attn_output": ["mp", "sharding"],
            "ffn_up": ["sharding", "mp"],
            "ffn_down": ["mp", "sharding"],
            "activations": ["dp", None, "mp"],
        },
    }


class CostModel:
    """The analytic plan scorer (the JAX package's ``CostModel``, its
    plan half)."""

    def __init__(self, coeffs: Optional[Coefficients] = None):
        self.coeffs = coeffs or Coefficients()

    def plan_cost(self, candidate: Sequence[int], batch_tokens: int,
                  param_bytes: int) -> float:
        return _plan_cost(candidate, batch_tokens, param_bytes, self.coeffs)

    def rank_plans(self, candidates: Iterable[Sequence[int]],
                   batch_tokens: int, param_bytes: int) -> List:
        """Candidates cheapest first; stable on ties."""
        return sorted(candidates, key=lambda c: self.plan_cost(
            c, batch_tokens, param_bytes))


_DEFAULT = CostModel()


def rank_plans(candidates, batch_tokens, param_bytes):
    return _DEFAULT.rank_plans(candidates, batch_tokens, param_bytes)


# primitive name → op class; anything unlisted is "elementwise"
_OP_CLASSES = {
    "matmul": {"dot_general", "conv_general_dilated", "einsum"},
    "reduce": {"reduce_sum", "reduce_max", "reduce_min", "reduce_prod",
               "reduce_and", "reduce_or", "argmax", "argmin",
               "reduce_precision", "cumsum", "cumprod", "sort"},
    "gather_scatter": {"gather", "scatter", "scatter-add", "scatter_add",
                       "dynamic_slice", "dynamic_update_slice", "take",
                       "take_along_axis"},
    "collective": {"psum", "all_gather", "reduce_scatter", "ppermute",
                   "all_to_all", "pmax", "pmin", "axis_index"},
    "control": {"while", "scan", "cond", "pjit", "custom_vjp_call",
                "custom_jvp_call", "remat", "checkpoint"},
}
def classify_primitive(name: str) -> str:
    for cls, names in _OP_CLASSES.items():
        if name in names:
            return cls
    return "elementwise"
