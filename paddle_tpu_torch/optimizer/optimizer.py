"""Optimizer base; counterpart of ``paddle_tpu/optimizer/optimizer.py``.

A ``torch.optim.Optimizer`` with Paddle's constructor.  What it keeps
from the JAX base:

* fp32 master weights for fp16/bf16 parameters under
  ``multi_precision`` (created from the low-precision value at the first
  step, as ``_get_master`` does), the parameter then rewritten from the
  updated master;
* fp32 accumulators;
* the learning rate as a device scalar, so a step reads nothing back to
  the host.

``grad_clip`` takes any clip of ``nn.clip`` (``ClipGradByValue``,
``ClipGradByNorm``, ``ClipGradByGlobalNorm`` and its MoE form
``ClipGradForMOEByGlobalNorm``): each step clips every gradient once,
just before the updates (a global norm's scale multiplied into the
gradients in place, one multi-tensor launch a dtype).  L1/L2 regularizers, LR schedulers and
parameter groups wait for a later slice and raise
``NotImplementedError``.

``amp.GradScaler`` steps an optimizer through :meth:`_unscale_targets`
(the gradients it unscales and checks) and skips a step with a
non-finite gradient by not calling :meth:`step` at all, so nothing of
the optimizer moves and no state is created on that step.

``state_dict()`` is torch's format (``{"state", "param_groups"}``, by
parameter index; the live accumulators, not copies), and the dict is
remembered as this optimizer's (``parallel._remember_checkpoint_owner``):
``distributed.checkpoint`` then saves and loads the live accumulators by each parameter's structured name
(``<name>_moment1``, ``<name>_moment2``, ``<name>_beta1_pow``,
``<name>_beta2_pow``, ``master_weights.<name>``, ``global_step``: the
JAX package's keys), whatever wrapper or layout holds them
(:meth:`Optimizer._checkpoint_pieces`).  ``set_state_dict`` takes
torch's format.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict

import torch

from ..nn.clip import ClipGradBase, ClipGradByGlobalNorm

__all__ = ["Optimizer"]

_LOW = (torch.float16, torch.bfloat16)


class Optimizer(torch.optim.Optimizer):
    """``weight_decay`` is kept for the subclasses (AdamW decays
    decoupled; Adam's coupled L2 raises until a slice supports it);
    ``name`` is a label, as in Paddle."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        if parameters is None:
            raise ValueError("parameters must be given (the port trains "
                             "eagerly, as Paddle's dygraph mode does)")
        if grad_clip is not None and not isinstance(grad_clip, ClipGradBase):
            raise NotImplementedError(
                f"grad_clip {type(grad_clip).__name__}: the port takes the "
                "clips of nn.clip (ClipGradByValue, ClipGradByNorm, "
                "ClipGradByGlobalNorm, ClipGradForMOEByGlobalNorm)")
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError("LR schedulers wait for a later "
                                      "slice; pass a float learning_rate")
        params = list(parameters)
        if any(isinstance(p, dict) for p in params):
            raise NotImplementedError("parameter groups wait for a later "
                                      "slice; pass a list of parameters")
        super().__init__(params, {})
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._name = name
        self._learning_rate = float(learning_rate)
        self._multi_precision = bool(multi_precision)
        # the learning rate as a one-element fp32 tensor per device
        self._lr: Dict[torch.device, torch.Tensor] = {}
        self._global_step = 0            # steps taken (the checkpoint's)

    def get_lr(self) -> float:
        return self._learning_rate

    def _lr_on(self, device) -> torch.Tensor:
        t = self._lr.get(device)
        if t is None:
            t = torch.tensor([self._learning_rate], dtype=torch.float32,
                             device=device)
            self._lr[device] = t
        return t

    # -- master weights ------------------------------------------------------
    def set_multi_precision(self, value: bool) -> None:
        self._multi_precision = bool(value)

    def _use_master(self, p: torch.Tensor) -> bool:
        return self._multi_precision and p.dtype in _LOW

    # -- step ------------------------------------------------------------------
    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        params = [p for group in self.param_groups for p in group["params"]]
        pg = [(p, p.grad) for p in params if p.grad is not None]
        clip = self._grad_clip
        if isinstance(clip, ClipGradByGlobalNorm):
            clip._clip_(pg, device=params[0].device if params else None)
        elif clip is not None:
            pg = clip(pg)
        for p, g in pg:
            self._update_param(p, g)
        self._global_step += 1
        return loss

    def _unscale_targets(self):
        """The gradients ``amp.GradScaler`` unscales and checks."""
        return [p.grad for group in self.param_groups
                for p in group["params"] if p.grad is not None]

    def _flag_group(self):
        """The group of the DataParallel reducer that holds the
        parameters, whose ranks must agree on a skip (None: none)."""
        from ..distributed.parallel import reducer_of
        for group in self.param_groups:
            for p in group["params"]:
                red = reducer_of(p)
                return red.group if red is not None else None
        return None

    def _update_param(self, p, g):
        raise NotImplementedError

    # -- state -----------------------------------------------------------------
    def state_dict(self):
        """torch's format, remembered as this optimizer's (module
        docstring)."""
        from ..distributed.parallel import _remember_checkpoint_owner
        sd = OrderedDict(super().state_dict())
        _remember_checkpoint_owner(sd, "", self)
        return sd

    def set_state_dict(self, state_dict) -> None:
        """Load torch's format (``load_state_dict``)."""
        self.load_state_dict(state_dict)

    def _checkpoint_state(self, p):
        """``p``'s state, made now if it has none (a load into a fresh
        optimizer needs somewhere to write)."""
        st = self.state[p]
        if not st and self._use_master(p):
            st["master"] = p.detach().float().clone()
        return st

    def _checkpoint_pieces(self, prefix: str, names, create: bool = False):
        """``(pieces, values)`` of this optimizer's state for
        ``distributed.checkpoint``: each parameter's accumulators keyed
        ``prefix + <name>_<accumulator>`` (``names``: id -> structured
        name), laid out as the parameter is (whole, or its mp shard's
        boxes); ``values`` the ``global_step``.  ``create`` makes missing
        state first (a load)."""
        from ..distributed.checkpoint.pieces import piece
        from ..distributed.fleet.meta_parallel.parallel_layers.mp_layers \
            import _checkpoint_layout
        pieces = []
        for group in self.param_groups:
            for p in group["params"]:
                name = _name_of(names, p)
                st = self._checkpoint_state(p) if create else \
                    self.state.get(p)
                if not st:
                    continue
                gshape, axis, boxes = _checkpoint_layout(p, p.shape)
                for skey, ckey in (("moment1", f"{name}_moment1"),
                                   ("moment2", f"{name}_moment2"),
                                   ("master", f"master_weights.{name}")):
                    if skey in st:
                        pieces.append(piece(prefix + ckey, st[skey], p.shape,
                                            gshape, axis, boxes))
                if "beta_pows" in st:
                    pieces += _pow_pieces(prefix, name, st["beta_pows"], piece)
        return pieces, {prefix + "global_step": self._global_step}

    def clear_grad(self, set_to_zero: bool = True) -> None:
        """Drop every gradient (``None``), as the JAX package's
        ``clear_grad`` does whatever ``set_to_zero`` says."""
        self.zero_grad(set_to_none=True)


def _name_of(names, p) -> str:
    name = names.get(id(p))
    if name is None:
        raise ValueError(
            "distributed.checkpoint: an optimizer parameter is in no model "
            "state dict of this checkpoint; save and load the model's "
            "state_dict() with the optimizer's, as "
            "{'model': model.state_dict(), 'opt': opt.state_dict()}")
    return name


def _pow_pieces(prefix, name, pows, piece):
    """The bias-correction powers ``[beta1^t, beta2^t]`` as two
    one-element pieces (``<name>_beta1_pow``, ``<name>_beta2_pow``)."""
    one = [((0,), (1,))]
    return [piece(prefix + f"{name}_beta{i + 1}_pow", pows[i:i + 1], (1,),
                  (1,), 0, one) for i in range(2)]
