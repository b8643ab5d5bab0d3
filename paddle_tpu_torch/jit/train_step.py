"""The training step; counterpart of ``paddle_tpu/jit/train_step.py``.

:func:`train_step` returns a callable ``step(*batch) -> loss`` that runs
the forward and the loss, ``backward``, ``optimizer.step()`` and
``optimizer.clear_grad()``, and returns the loss as a device tensor.

It is eager: no ``torch.compile`` (the JAX package jits the whole step
into one XLA program; here each op launches on its own, the hand-written
kernels included).  CUDA graphs over the step are later work.  Nothing in
the step reads a device value back to the host, so the caller decides
when to synchronise (``float(loss)`` does).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["TrainStep", "train_step"]


class TrainStep:
    """The reference's parameters in its order.  ``mesh`` and
    ``batch_spec`` (an SPMD mesh and its batch sharding) wait for the
    distributed slice and raise ``NotImplementedError`` when given;
    ``donate`` changes nothing here (the eager step updates the
    parameters in place either way)."""

    def __init__(self, model, loss_fn=None, optimizer=None, scaler=None,
                 mesh=None, batch_spec=None, step_fn=None,
                 donate: bool = True):
        if scaler is not None:
            raise NotImplementedError("GradScaler waits for a later slice")
        if mesh is not None or batch_spec is not None:
            raise NotImplementedError("a mesh and batch_spec wait for the "
                                      "distributed slice")
        if loss_fn is None and step_fn is None:
            raise ValueError("give loss_fn or step_fn")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.step_fn = step_fn
        model.train()

    def _to_device(self, x):
        dev = next(self.model.parameters()).device
        if isinstance(x, torch.Tensor):
            return x.to(dev)
        return torch.as_tensor(np.asarray(x), device=dev)

    def __call__(self, *batch):
        batch = [self._to_device(b) for b in batch]
        if self.step_fn is not None:
            loss = self.step_fn(self.model, *batch)
        else:
            loss = self.loss_fn(self.model(batch[0]), *batch[1:])
        if self.optimizer is not None:
            loss.backward()
            self.optimizer.step()
            self.optimizer.clear_grad()
        return loss.detach()


def train_step(model, loss_fn=None, optimizer=None, scaler=None,
               mesh=None, **kwargs) -> TrainStep:
    """Build the training step of ``model``: ``step_fn(model, *batch)``
    returns the loss (or ``loss_fn(model(batch[0]), *batch[1:])`` does);
    the model is put in training mode.  ``kwargs`` are
    :class:`TrainStep`'s (``batch_spec``, ``step_fn``, ``donate``)."""
    return TrainStep(model, loss_fn, optimizer, scaler, mesh=mesh, **kwargs)
