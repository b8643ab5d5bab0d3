"""Fused functional ops; counterpart of
``paddle_tpu/incubate/nn/functional/__init__.py``.

* :func:`fused_rms_norm` — RMSNorm over the last axis through K4a/K4b
  (``ops.rms_norm``), black-listed under amp as ``"rms_norm"``: under O2
  a bf16 x goes up to fp32 and the output stays fp32;
* :func:`fused_rotary_position_embedding` — rotates q/k (and v) by the
  sin/cos tables.  It takes K5 (``ops.rope``) when the tables are plain
  ``[S, D]``, no ``position_ids`` are given, the head dim is even and the
  tables repeat each frequency across its rotated pair (the JAX route's
  gate; the table check reads the device once per table, see
  ``_pair_repeating``); otherwise the plain composition, as in the JAX
  package.  That is routing by shape, not a fallback: on CUDA tensors the
  kernel route launches or raises.  ``"fused_rope"`` is not black-listed, so under O2
  x and the fp32 tables are all cast to bf16 before the kernel computes
  in fp32, as the JAX dispatch casts them.

Under ``static.capture_ops`` the norm records one single-output
``rms_norm`` op of ``(x, weight)`` (and the bias where given), and the
rope one ``fused_rope`` op per rotated tensor, as the JAX dispatch
records them.
"""
from __future__ import annotations

import weakref

import torch

from ... import amp
from ...ops import rms_norm as _rms
from ...ops import rope as _rope
from ...static.capture import recorded

__all__ = ["fused_rms_norm", "fused_rotary_position_embedding"]


# Paddle's further ``fused_rms_norm`` parameters and their defaults: the
# reference takes them through ``**kw`` and ignores them; the port raises
# when one asks for what it would mean (a residual add, a bias before the
# norm, int8 output)
_RMS_NORM_KW = {"bias": None, "residual": None, "quant_scale": -1,
                "quant_round_type": 0, "quant_max_bound": 0,
                "quant_min_bound": 0}


def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon: float = 1e-6,
                   begin_norm_axis: int = -1, **kw):
    """``x * rsqrt(mean(x², -1) + eps) * w (+ bias)``; returns ``(out,
    None)`` as Paddle does.  Only the last axis is normalised.  Keywords
    are taken as the reference takes them; one of Paddle's (``bias``,
    ``residual``, the ``quant_*`` four) at other than its default raises
    ``NotImplementedError``."""
    asked = sorted(k for k, v in kw.items()
                   if k in _RMS_NORM_KW and v != _RMS_NORM_KW[k])
    if asked:
        raise NotImplementedError(f"fused_rms_norm {asked}: a residual add, "
                                  "a pre-norm bias and quantised output "
                                  "wait for a later slice")
    if begin_norm_axis % x.dim() != x.dim() - 1:
        raise NotImplementedError(f"begin_norm_axis={begin_norm_axis}: "
                                  "only the last axis is normalised")
    return _rms_norm(x, norm_weight, norm_bias, epsilon), None


@recorded("rms_norm")
def _rms_norm(x, norm_weight, norm_bias=None, epsilon: float = 1e-6):
    x, w, b = amp.cast("rms_norm", x, norm_weight, norm_bias)
    out = _rms.rms_norm(x, w, float(epsilon))
    return out + b if b is not None else out


# memo of table checks: (base tensor, version, style) for a table whose
# rows are rows of its base, else (base, view geometry, version, style) ->
# (weak reference to the base, verdict).  A model slices its tables from
# one tensor made at build time: the whole base is checked once, and every
# row slice of it (the eager decode loop slices one position per token)
# inherits the verdict without reading the device again.
_pair_repeat_memo = {}
# device reads the checks made (a test counts them)
table_checks = 0


def _rows_of(table, base) -> bool:
    """True iff ``table`` is a run of whole rows of the 2-D contiguous
    ``base`` (``base[i:j]``)."""
    return (table.dim() == 2 and base.dim() == 2 and base.is_contiguous()
            and table.shape[1] == base.shape[1]
            and table.stride() == base.stride()
            and (table.storage_offset() - base.storage_offset())
            % base.stride(0) == 0)


def _pair_repeating(table, neox: bool) -> bool:
    """True iff each frequency repeats across its rotated pair
    (``t[2i] == t[2i+1]`` interleaved, ``t[j] == t[j+D/2]`` neox): the
    invariant under which the kernel's backward (the same rotation with
    −sin) is the true transpose.  Unlike the JAX check, nothing here is
    traced, so every table can be checked."""
    global table_checks
    base = table._base if table._base is not None else table
    whole_rows = table is base or _rows_of(table, base)
    if whole_rows:
        checked = base
        key = (id(base), base._version, bool(neox))
    else:
        checked = table
        key = (id(base), table.storage_offset(), tuple(table.shape),
               tuple(table.stride()), base._version, bool(neox))
    hit = _pair_repeat_memo.get(key)
    if hit is not None and hit[0]() is base:
        return hit[1]
    d = checked.shape[-1]
    if neox:
        ok = bool(torch.equal(checked[..., :d // 2], checked[..., d // 2:]))
    else:
        ok = bool(torch.equal(checked[..., 0::2], checked[..., 1::2]))
    table_checks += 1
    if len(_pair_repeat_memo) > 256:
        _pair_repeat_memo.clear()
    _pair_repeat_memo[key] = (weakref.ref(base), ok)
    return ok


def _composition(x, s, c, neox: bool, position_ids=None):
    """The JAX package's plain route on ``x [B, S, H, D]`` with ``[S, D]``
    or ``[B, S, D]`` tables, in x's dtype.  Like it, this rotates by the
    tables' first rows whatever ``position_ids`` say, so only the
    positions ``0..S-1`` of every row are taken; others raise."""
    if position_ids is not None:
        want = torch.arange(x.shape[1], device=position_ids.device)
        if not torch.equal(position_ids, want.expand_as(position_ids)):
            raise NotImplementedError(
                "position_ids other than 0..S-1 wait for the slice that "
                "needs them (the JAX composition does not read them)")
    if neox:
        x1, x2 = x.chunk(2, dim=-1)
        rot = torch.cat([-x2, x1], dim=-1)
    else:
        rot = torch.stack([-x[..., 1::2], x[..., 0::2]],
                          dim=-1).reshape(x.shape)
    if s.dim() == 2:
        s, c = s[None], c[None]
    if s.dim() == 3:                   # [B, S, D]: insert the head axis
        s, c = s[:, :, None, :], c[:, :, None, :]
    return x * c + rot * s


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style: bool = True):
    """Rotate each of ``q``, ``k``, ``v`` (``[B, S, H, D]``, any may be
    None) by ``sin``/``cos``; returns the three (None stays None)."""
    return tuple(None if t is None else
                 _fused_rope(t, sin, cos, position_ids,
                             bool(use_neox_rotary_style))
                 for t in (q, k, v))


@recorded("fused_rope")
def _fused_rope(x, sin, cos, position_ids=None,
                use_neox_rotary_style: bool = True):
    """One rotated tensor: K5 or the plain composition (see the module
    docstring for the gate)."""
    neox = use_neox_rotary_style
    # the port's head-dim rule is an even D; the JAX gate's d % 8 is the
    # TPU's lane tiling
    use_kernel = (sin.dim() == 2 and position_ids is None
                  and x.shape[-1] % 2 == 0 and _pair_repeating(sin, neox))
    x, s, c = amp.cast("fused_rope", x, sin, cos)
    if use_kernel:
        return _rope.rope(x, c, s, neox)
    return _composition(x, s, c, neox, position_ids)
