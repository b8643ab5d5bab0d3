"""Sep (Ulysses) and cp (ring attention): the user-reachable wiring;
counterpart of ``paddle_tpu/distributed/fleet/meta_parallel/
segment_parallel.py`` (ref: ``fleet/meta_parallel/segment_parallel.py``).

When the fleet topology has a ``sep_degree`` or ``cp_degree`` above 1,
``nn.functional.scaled_dot_product_attention`` routes here before its
local paths.  Each rank holds its sequence chunk ``[B, S_local, H, D]``
(``jit.train_step`` slices the sequence; the models offset positions by
the rank's chunk):

- **sep** -> :func:`paddle_tpu_torch.ops.ulysses.ulysses_attention`;
- **cp** -> :func:`paddle_tpu_torch.ops.ring_attention.ring_attention_bhsd`
  (heads-major ``[H*B, S_local, D]``, as the reference lays it out).

Where a call falls outside the kernels' rules (the reference's
warn-once conditions) the JAX package attends its global tensor plainly.
Here a rank holds only its chunk, so :func:`gathered_attention` gathers
q, k and v over the group (backward: the sum of the ranks' partial
gradients, each rank's chunk), attends the whole sequence and keeps the
rank's rows: the same numbers, without the sharded layout.

``launches`` counts the routes taken (``sep``, ``cp``, ``fallback``),
each call once.
"""
from __future__ import annotations

import math
import warnings
from typing import Optional, Tuple

from ....ops.flash_attention import DEFAULT_BLOCK_Q
from ....ops.ring_attention import ring_attention_bhsd
from ....ops.ulysses import ulysses_attention
from ..base.topology import get_hybrid_communicate_group

__all__ = ["active_seq_parallel_axis", "segment_parallel_attention",
           "sep_attention", "cp_ring_attention", "gathered_attention",
           "launches"]

# routes taken, each call once
launches = {"sep": 0, "cp": 0, "fallback": 0}

_warned: set = set()


def _warn_once(key: str, msg: str):
    if key not in _warned:
        _warned.add(key)
        warnings.warn(msg, RuntimeWarning, stacklevel=3)


def active_seq_parallel_axis() -> Optional[Tuple[str, int]]:
    """The live long-context axis of the fleet topology: ``("sep", n)``
    or ``("cp", n)``, or None when neither degree is above 1."""
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        return None
    sep = hcg.get_sep_parallel_world_size()
    if sep > 1:
        return ("sep", sep)
    cp = hcg.get_context_parallel_world_size()
    if cp > 1:
        return ("cp", cp)
    return None


def seq_parallel_group():
    """The live axis's group (None without one)."""
    axis = active_seq_parallel_axis()
    if axis is None:
        return None
    hcg = get_hybrid_communicate_group()
    return hcg.get_sep_parallel_group() if axis[0] == "sep" \
        else hcg.get_context_parallel_group()


def sep_attention(query, key, value, is_causal: bool = True, scale=None):
    """Ulysses attention over the sep group; q / k / v are this rank's
    ``[B, S_local, H, D]``."""
    sc = scale if scale is not None else 1.0 / math.sqrt(query.shape[-1])
    launches["sep"] += 1
    return ulysses_attention(query, key, value, "sep", sc, is_causal)


def cp_ring_attention(query, key, value, is_causal: bool = True,
                      scale=None):
    """Ring attention over the cp group; this rank's ``[B, S_local, H,
    D]`` flattened heads-major to ``[H*B, S_local, D]``."""
    b, s, h, d = query.shape
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    qt, kt, vt = (t.permute(2, 0, 1, 3).reshape(h * b, s, d)
                  for t in (query, key, value))
    launches["cp"] += 1
    out = ring_attention_bhsd(qt, kt, vt, "cp", sc, is_causal)
    return out.reshape(h, b, s, d).permute(1, 2, 0, 3)


def gathered_attention(query, key, value, attend):
    """The fallback: q, k, v gathered along the sequence over the live
    group (backward: reduce-scatter), ``attend(q, k, v)`` on the whole
    sequence, this rank's rows kept."""
    from ..utils.sequence_parallel_utils import AllGatherOp
    group = seq_parallel_group()
    launches["fallback"] += 1
    s = query.shape[1]
    q, k, v = (AllGatherOp.apply(t, 1, group) for t in (query, key, value))
    out = attend(q, k, v)
    return out[:, group.rank * s:(group.rank + 1) * s]


def segment_parallel_attention(query, key, value, attn_mask, dropout_p,
                               is_causal, training):
    """Route one attention call through the live sep / cp axis, or return
    None (the caller then takes :func:`gathered_attention`) with a
    one-time warning when the call cannot run that way.  Shapes are this
    rank's; the global sequence is ``n`` times its length."""
    axis = active_seq_parallel_axis()
    if axis is None:
        return None
    name, n = axis
    if attn_mask is not None:
        _warn_once(f"{name}-mask",
                   f"{name}_degree={n} is set but this attention call "
                   "passes an attn_mask; falling back to plain attention "
                   "(sequence gathered) for masked calls")
        return None
    if dropout_p > 0.0 and training:
        _warn_once(f"{name}-dropout",
                   f"{name}_degree={n} is set but attention dropout > 0; "
                   "the flash-based sequence-parallel kernels don't carry "
                   "dropout — falling back to plain attention. Set "
                   "attention dropout to 0 to enable sep/cp")
        return None
    B, s_loc, H, D = query.shape
    if s_loc != key.shape[1]:
        _warn_once(f"{name}-crossattn",
                   f"{name}_degree={n}: q/k sequence lengths differ "
                   f"({s_loc} vs {key.shape[1]}); sequence parallelism "
                   "applies to self-attention — falling back")
        return None
    S = s_loc * n
    if D % 8:
        _warn_once(f"{name}-headdim",
                   f"{name}_degree={n}: head_dim {D} not a multiple of 8 "
                   "(flash kernel lane constraint); falling back")
        return None
    if name == "sep":
        if H % n:
            _warn_once("sep-heads",
                       f"sep_degree={n} does not divide num_heads {H}; "
                       "Ulysses needs heads % sep == 0 — falling back")
            return None
        bq = min(DEFAULT_BLOCK_Q, S)
        if S % bq:
            _warn_once("sep-block",
                       f"sep: global sequence {S} not aligned to the "
                       f"flash block ({bq}); falling back")
            return None
        return sep_attention(query, key, value, is_causal)
    bq = min(DEFAULT_BLOCK_Q, s_loc)
    if s_loc % bq:
        _warn_once("cp-block",
                   f"cp: per-rank sequence {s_loc} not aligned to the "
                   f"flash block ({bq}); falling back")
        return None
    return cp_ring_attention(query, key, value, is_causal)
