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

The casts are explicit, not ``torch.autocast``: its op lists differ from
Paddle's and would break parity with the JAX package.  O1 and
``GradScaler`` wait for a later slice and raise ``NotImplementedError``;
the kernels take fp32 and bf16, so ``float16`` raises too.  The
defaults are Paddle's (``auto_cast``: O1, float16; ``decorate``: O2,
float16), so a caller names ``level="O2", dtype="bfloat16"``.
"""
from __future__ import annotations

import contextlib
from typing import Optional

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


class GradScaler:
    """Dynamic loss scaling waits for a later slice (bf16 O2 trains
    without it)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("GradScaler waits for a later slice; "
                                  "bf16 O2 training needs no loss scaling")
