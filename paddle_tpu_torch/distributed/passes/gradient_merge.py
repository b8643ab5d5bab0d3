"""Gradient merge — k-step gradient accumulation; a port of
``paddle_tpu/distributed/passes/gradient_merge.py``.

An optimizer wrapper: autograd leaves summed gradients in ``param.grad``
across backward calls when ``clear_grad`` is withheld, so the wrapper
counts steps, scales the gradients by 1/k on the k-th call
(``avg=True``) and skips the off-boundary ``step()`` / ``clear_grad()``
calls.  Under ``DataParallel`` each backward averages over the ranks, so
the merged gradient is the average of the ranks' sums.
"""
from __future__ import annotations

import torch

__all__ = ["GradientMergeOptimizer"]


class GradientMergeOptimizer:
    """Apply the inner optimizer every ``k_steps`` calls; the loop stays
    ``loss.backward(); opt.step(); opt.clear_grad()``."""

    def __init__(self, inner_opt, k_steps: int = 1, avg: bool = True):
        if k_steps < 1:
            raise ValueError(f"k_steps must be >= 1, got {k_steps}")
        self._inner = inner_opt
        self.k_steps = int(k_steps)
        self.avg = bool(avg)
        self._step_count = 0

    @torch.no_grad()
    def step(self):
        self._step_count += 1
        if self._step_count % self.k_steps:
            return            # accumulation step: no update
        if self.avg and self.k_steps > 1:
            inv = 1.0 / self.k_steps
            for p in self._parameters():
                if p.grad is not None:
                    p.grad.mul_(inv)
        self._inner.step()

    def clear_grad(self, set_to_zero: bool = True):
        if self._step_count % self.k_steps:
            return            # keep accumulating
        self._inner.clear_grad(set_to_zero)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        params_grads = [(p, p.grad) for p in self._parameters()
                        if p.grad is not None]
        self.step()
        self.clear_grad()
        return None, params_grads

    def _parameters(self):
        inner = self._inner_opt
        return [p for g in inner.param_groups for p in g["params"]]

    @property
    def _inner_opt(self):
        return getattr(self._inner, "_inner_opt", self._inner)

    def state_dict(self):
        sd = self._inner.state_dict()
        sd["gradient_merge_step"] = self._step_count
        return sd

    def set_state_dict(self, sd):
        sd = dict(sd)
        self._step_count = int(sd.pop("gradient_merge_step", 0))
        load = getattr(self._inner, "set_state_dict", None) \
            or self._inner.load_state_dict
        load(sd)

    def get_lr(self):
        return self._inner.get_lr()

    def __getattr__(self, name):
        inner = self.__dict__.get("_inner")
        if inner is None:
            raise AttributeError(name)
        return getattr(inner, name)
