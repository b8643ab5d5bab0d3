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

``grad_clip`` takes ``nn.clip.ClipGradByGlobalNorm`` and its MoE form
(``ClipGradForMOEByGlobalNorm``): each step computes the scale once over
every gradient and multiplies each gradient by it, in the gradient's
dtype, just before its update.  Other clip classes, L1/L2
regularizers, LR schedulers and parameter groups wait for a later slice
and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict

import torch

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
        from ..nn.clip import ClipGradByGlobalNorm
        if grad_clip is not None and \
                not isinstance(grad_clip, ClipGradByGlobalNorm):
            raise NotImplementedError(
                f"grad_clip {type(grad_clip).__name__} waits for a later "
                "slice (ClipGradByGlobalNorm and ClipGradForMOEByGlobalNorm "
                "run)")
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
        params = [p for group in self.param_groups for p in group["params"]
                  if p.grad is not None]
        scale = None
        if self._grad_clip is not None:
            scale = self._grad_clip.scale([(p, p.grad) for p in params])
        for p in params:
            g = p.grad
            if scale is not None:
                g = g * scale.to(g.dtype)
            self._update_param(p, g)
        return loss

    def _update_param(self, p, g):
        raise NotImplementedError

    def clear_grad(self, set_to_zero: bool = True) -> None:
        """Drop every gradient (``None``), as the JAX package's
        ``clear_grad`` does whatever ``set_to_zero`` says."""
        self.zero_grad(set_to_none=True)
