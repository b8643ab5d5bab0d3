"""Automatic mixed precision, level O2; counterpart of
``paddle_tpu/amp/__init__.py``.

* :func:`decorate` casts every fp32 parameter of a model to the low dtype
  except those of norm layers (``_FP32_KEEP_LAYERS``), and turns on
  ``multi_precision`` in the optimizer, which then keeps fp32 master
  weights.
* :func:`auto_cast` sets a module state that the port's
  ``nn.functional`` routes and the model's layers read through
  :func:`cast`, with the O2 rule of the JAX package's dispatch hook: an
  op on ``BLACK_LIST`` casts low-precision inputs up to fp32, every other
  op casts fp32 inputs down to the low dtype.

* :class:`GradScaler` is dynamic loss scaling with the JAX package's
  rules: the loss times the scale; the gradients unscaled in fp32 and
  cast back to their dtype; a step with a non-finite gradient skipped
  (nothing of the optimizer moves) and the scale cut; the scale grown
  after ``incr_every_n_steps`` clean steps.

The casts are explicit, not ``torch.autocast``: its op lists differ from
Paddle's and would break parity with the JAX package.  O1 waits for a
later slice and raises ``NotImplementedError``; the kernels take fp32
and bf16, so ``float16`` raises too.  The defaults are Paddle's
(``auto_cast``: O1, float16; ``decorate``: O2, float16), so a caller
names ``level="O2", dtype="bfloat16"``.

**One skip decision on every rank.**  Each rank checks the gradients it
steps (whole gradients, or under ZeRO its gradient shards: the
optimizer's ``_unscale_targets``), after the hybrid optimizer's
reductions; under mp, pp, sharding and ep the ranks hold different
values, so the flag is MAX-all-reduced over the whole world (one
collective a step; without a fleet topology, over the group of the
optimizer's DataParallel reducer or sharding group, and over none for a
model of one process).  The skip itself costs **one host read a step**:
the reduced flag is read back (``GradScaler.host_reads`` counts them) and
a skipped step launches nothing of the optimizer (no K3, no beta-power
advance, no master or moment write), so no state is created on it.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

__all__ = ["BLACK_LIST", "auto_cast", "cast", "decorate", "GradScaler"]

# Paddle's black list (python/paddle/amp/auto_cast.py), as the JAX package
# keeps it; O2 reads no other list
BLACK_LIST = {
    "exp", "square", "log", "mean", "sum", "cos_sim", "softmax",
    "softmax_with_cross_entropy", "sigmoid_cross_entropy_with_logits",
    "cross_entropy", "cross_entropy2", "log_softmax", "layer_norm",
    "batch_norm", "rms_norm", "reduce_mean", "reduce_sum", "norm",
    "cumsum", "logsumexp", "erfinv", "pow",
}

_FP32_KEEP_LAYERS = ("BatchNorm", "LayerNorm", "GroupNorm", "InstanceNorm",
                     "SyncBatchNorm", "RMSNorm")

_LOW = (torch.float16, torch.bfloat16)


class _AmpState:
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16


_state = _AmpState()


def _low_dtype(dtype: str) -> torch.dtype:
    if dtype != "bfloat16":
        raise NotImplementedError(
            f"amp dtype {dtype!r}: the port's kernels take float32 and "
            "bfloat16; use dtype='bfloat16'")
    return torch.bfloat16


def _check_level(level: str) -> None:
    if level == "O1":
        raise NotImplementedError("amp level O1 waits for a later slice; "
                                  "use level='O2'")
    if level != "O2":
        raise ValueError(f"unknown amp level {level!r}")


@contextlib.contextmanager
def auto_cast(enable: bool = True, custom_white_list=None,
              custom_black_list=None, level: str = "O1",
              dtype: str = "float16", use_promote: bool = True):
    """``paddle.amp.auto_cast`` at level O2: inside the block, the port's
    ops cast their inputs by the O2 rule (see :func:`cast`).  Custom
    white or black lists and ``use_promote=False`` wait for a later
    slice and raise ``NotImplementedError``."""
    if custom_white_list or custom_black_list:
        raise NotImplementedError("custom amp op lists wait for a later "
                                  "slice")
    if not use_promote:
        raise NotImplementedError("use_promote=False waits for a later "
                                  "slice")
    if enable:
        _check_level(level)
        low = _low_dtype(dtype)
    else:
        low = _state.dtype
    prev = (_state.enabled, _state.dtype)
    _state.enabled, _state.dtype = bool(enable), low
    try:
        yield
    finally:
        _state.enabled, _state.dtype = prev


def _current():
    """The amp state in force now (``fleet.recompute`` replays it)."""
    return (_state.enabled, _state.dtype)


@contextlib.contextmanager
def _restored(saved):
    """Run the block under the amp state ``_current`` returned."""
    prev = (_state.enabled, _state.dtype)
    _state.enabled, _state.dtype = saved
    try:
        yield
    finally:
        _state.enabled, _state.dtype = prev


def cast(op_name: str, *tensors):
    """The O2 rule for one op's inputs: under :func:`auto_cast`, an op on
    ``BLACK_LIST`` casts fp16/bf16 inputs to fp32 and any other op casts
    fp32 inputs to the low dtype; outside it, or for non-float inputs,
    the inputs pass unchanged.  Returns a tuple (``None`` passes)."""
    if not _state.enabled:
        return tensors
    if op_name in BLACK_LIST:
        return tuple(t.float() if t is not None and t.dtype in _LOW else t
                     for t in tensors)
    low = _state.dtype
    return tuple(t.to(low) if t is not None and t.dtype == torch.float32
                 else t for t in tensors)


def decorate(models, optimizers=None, level: str = "O2",
             dtype: str = "float16", master_weight: Optional[bool] = None,
             save_dtype: Optional[str] = None, master_grad: bool = False,
             excluded_layers=None):
    """``paddle.amp.decorate`` at level O2: cast every fp32 parameter to
    ``dtype`` in place (the ``Parameter`` objects stay, so an optimizer
    built before keeps them), except those of norm layers and of the
    layer types in ``excluded_layers``; set ``multi_precision`` on the
    optimizers unless ``master_weight`` is False.  Returns what it was
    given, as Paddle does.  ``save_dtype`` and ``master_grad=True`` wait
    for a later slice and raise ``NotImplementedError``."""
    if save_dtype is not None:
        raise NotImplementedError("save_dtype waits for a later slice")
    if master_grad:
        raise NotImplementedError("master_grad waits for a later slice")
    _check_level(level)
    low = _low_dtype(dtype)
    excluded = tuple(excluded_layers or ())
    single_model = isinstance(models, torch.nn.Module)
    model_list = [models] if single_model else list(models)
    for model in model_list:
        for layer in model.modules():
            if any(k in type(layer).__name__ for k in _FP32_KEEP_LAYERS):
                continue
            if excluded and isinstance(layer, excluded):
                continue
            for p in layer._parameters.values():
                if p is not None and p.dtype == torch.float32:
                    p.data = p.data.to(low)
    if optimizers is None:
        return model_list[0] if single_model else model_list
    single_opt = not isinstance(optimizers, (list, tuple))
    opt_list = [optimizers] if single_opt else list(optimizers)
    for opt in opt_list:
        if master_weight is not False:
            opt.set_multi_precision(True)
    return (model_list[0] if single_model else model_list,
            opt_list[0] if single_opt else opt_list)


def _flag_group(optimizer):
    """The ranks whose skip decisions must agree: every rank under a fleet
    topology (the hybrid world), else the group of the optimizer's
    distributed wrapper (its DataParallel reducer or its sharding group),
    else none (a model of this process alone)."""
    from ..distributed.fleet.base.topology import (
        get_hybrid_communicate_group)
    hcg = get_hybrid_communicate_group()
    if hcg is not None and hcg.nranks > 1:
        from ..distributed.communication.group import _resolve_group
        return _resolve_group(None)
    return optimizer._flag_group()


class GradScaler:
    """ref: ``python/paddle/amp/grad_scaler.py`` (module docstring).  The
    reference's parameters in its order.  The scale is decided on the
    host in fp32 arithmetic, as the JAX package computes it, and kept
    there and as ``_scale``, a 0-d fp32 tensor on the loss's device (moved
    at the first :meth:`scale`); the counters are host integers."""

    def __init__(self, enable: bool = True,
                 init_loss_scaling: float = 65536.0,
                 incr_ratio: float = 2.0, decr_ratio: float = 0.5,
                 incr_every_n_steps: int = 2000,
                 decr_every_n_nan_or_inf: int = 1,
                 use_dynamic_loss_scaling: bool = True):
        self._enable = enable
        self._scale = torch.tensor(0.0)
        self._set(init_loss_scaling)
        self._incr_ratio = float(incr_ratio)
        self._decr_ratio = float(decr_ratio)
        self._incr_every_n_steps = int(incr_every_n_steps)
        self._decr_every_n_nan_or_inf = int(decr_every_n_nan_or_inf)
        self._use_dynamic = use_dynamic_loss_scaling
        self._incr_count = 0
        self._decr_count = 0
        self._found_inf: Optional[bool] = None
        self._local_found_inf: Optional[torch.Tensor] = None
        self._unscaled = False
        self.host_reads = 0

    def _set(self, value) -> None:
        """The scale on the host (fp32) and as ``_scale`` on its device."""
        self._value = np.float32(value)
        self._scale = torch.full((), float(self._value), dtype=torch.float32,
                                 device=self._scale.device)

    def is_enable(self) -> bool:
        return self._enable

    def is_use_dynamic_loss_scaling(self) -> bool:
        return self._use_dynamic

    def _on(self, device) -> torch.Tensor:
        if self._scale.device != torch.device(device):
            self._scale = self._scale.to(device)
        return self._scale

    def scale(self, var: torch.Tensor) -> torch.Tensor:
        """``var`` times the scale cast to ``var``'s dtype (a float16 loss
        in fp32, as the JAX package promotes it)."""
        if not self._enable:
            return var
        if var.dtype == torch.float16:
            var = var.float()
        return var * self._on(var.device).to(var.dtype)

    @torch.no_grad()
    def unscale_(self, optimizer) -> None:
        """Every gradient ``optimizer`` steps times ``1 / scale``, the
        product in fp32 rounded to the gradient's dtype once (as the JAX
        package casts it back); sets the step's ``found_inf`` from the
        unscaled values (one MAX all-reduce, one host read)."""
        if not self._enable or self._unscaled:
            return
        grads = optimizer._unscale_targets()
        dev = grads[0].device if grads else self._scale.device
        inv = float(np.float32(1.0) / self._value)
        local = torch.zeros((), dtype=torch.float32, device=dev)
        by_dtype = {}
        for g in grads:
            by_dtype.setdefault(g.dtype, []).append(g)
        for gs in by_dtype.values():
            # a host scalar multiplies in fp32 (opmath) and rounds once
            torch._foreach_mul_(gs, inv)
            # the largest magnitude: non-finite iff some element is
            peak = torch.stack(torch._foreach_norm(gs, float("inf")))
            local = torch.maximum(local, (~torch.isfinite(peak)).any()
                                  .to(torch.float32))
        self._local_found_inf = local
        found = local
        group = _flag_group(optimizer)
        if group is not None and group.nranks > 1:
            from ..distributed.communication.collective_ops import (
                all_reduce)
            from ..distributed.communication.group import ReduceOp
            found = local.clone()
            all_reduce(found, op=ReduceOp.MAX, group=group)
        self.host_reads += 1
        self._found_inf = bool(found.item())
        self._unscaled = True

    def step(self, optimizer) -> None:
        """Unscale, then ``optimizer.step()`` unless a gradient is
        non-finite on some rank (then nothing of the optimizer moves)."""
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if self._found_inf:
            skip = getattr(optimizer, "_skip_step", None)
            if skip is not None:
                skip()
            return
        optimizer.step()

    def update(self) -> None:
        """The JAX package's growth and decrease counters, its scale in
        fp32."""
        found = bool(self._found_inf)
        if self._enable and self._use_dynamic:
            decr = self._decr_count + 1 if found else 0
            incr = 0 if found else self._incr_count + 1
            do_decr = decr >= self._decr_every_n_nan_or_inf
            do_incr = incr >= self._incr_every_n_steps
            value = self._value
            if do_decr:
                value = max(value * np.float32(self._decr_ratio),
                            np.float32(1.0))
            if not found and do_incr:
                value = value * np.float32(self._incr_ratio)
            if value != self._value:
                self._set(value)
            self._decr_count = 0 if do_decr else decr
            self._incr_count = 0 if do_incr else incr
        self._found_inf = None
        self._unscaled = False

    def minimize(self, optimizer, scaled_loss) -> None:
        """The reference's contract: the caller has run
        ``scaled_loss.backward()``; this unscales, steps and updates."""
        self.step(optimizer)
        self.update()

    def get_init_loss_scaling(self) -> float:
        return float(self._value)

    def set_init_loss_scaling(self, v) -> None:
        self._set(v)

    def state_dict(self):
        return {"scale": float(self._value),
                "incr_count": int(self._incr_count),
                "decr_count": int(self._decr_count),
                "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_every_n_steps": self._incr_every_n_steps,
                "decr_every_n_nan_or_inf": self._decr_every_n_nan_or_inf,
                "use_dynamic_loss_scaling": self._use_dynamic}

    def set_state_dict(self, state) -> None:
        self._set(state.get("scale", self._value))
        self._incr_count = int(state.get("incr_count", 0))
        self._decr_count = int(state.get("decr_count", 0))
