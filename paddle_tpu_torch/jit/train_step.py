"""The training step; counterpart of ``paddle_tpu/jit/train_step.py``.

:func:`train_step` returns a callable ``step(*batch) -> loss`` that runs
the forward and the loss, ``backward``, ``optimizer.step()`` and
``optimizer.clear_grad()``, and returns the loss as a device tensor.
With a ``scaler`` (``amp.GradScaler``) the order is the JAX package's:
``scaler.scale(loss).backward()``, ``scaler.step(optimizer)``,
``scaler.update()``; the scaler's skip decision is its one host read a
step.

It is eager: no ``torch.compile`` (the JAX package jits the whole step
into one XLA program; here each op launches on its own, the hand-written
kernels included).  CUDA graphs over the step are later work.  Nothing in
the step reads a device value back to the host, so the caller decides
when to synchronise (``float(loss)`` does).

With a ``mesh`` (``distributed.build_mesh``, or fleet's) the step takes
the **global** batch, as the JAX package's GSPMD step does: each rank
keeps its rows along the mesh's data axes (``dp`` and ``sharding``, or
the axes ``batch_spec[0]`` names), gradients are averaged over those
ranks (by the model's DataParallel or group-sharded reducer, or by a
DataParallel the step builds over the data group for a bare model), and
the returned loss is the global mean: the average of the ranks' losses
over equal shards.  Without a mesh each rank's batch is its own (the
upstream ``DataParallel`` idiom).

Under an expert axis ``ep`` the ranks of an ep group take the same rows
(the data axes are ``dp`` and ``sharding`` only, as on the JAX mesh)
and hold different experts; the MoE layers place their own collectives
(``incubate.distributed.models.moe``).

Under model, sep or cp parallelism (a mesh axis ``mp``, ``sep`` or
``cp`` above 1) the ranks of those axes take the same rows; under
``sep`` or ``cp`` each keeps its contiguous chunk of the sequence
(dimension 1 of every batch tensor) as well.  A tensor-parallel model
(mp layers built split over ranks, or a sep / cp axis) has its gradients
reduced by ``HybridParallelOptimizer`` (``fleet.distributed_optimizer``),
not by a DataParallel the step builds, and its criterion sums over the
sequence's chunks itself.  Any other model under an ``mp`` axis (plain
layers, or the semi-auto placements of ``auto_parallel``, whose
``Linear`` layers split and sum by themselves) gets the DataParallel
over the data axes: the mp ranks of a data row take the same rows.
A model with placed parameters is checked against the semi-auto rule
table first (``auto_parallel.api.check_placements``).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["TrainStep", "train_step"]

# axes whose degree above 1 this step does not run: pipelines have their
# own schedules (fleet.meta_parallel)
_LATER_AXES = ("pp",)


def _hybrid(optimizer) -> bool:
    """Whether ``optimizer`` (or what a gradient-merge window holds) is
    ``HybridParallelOptimizer``, which reduces a tensor-parallel model's
    gradients."""
    from ..distributed.fleet.meta_optimizers.dygraph_optimizer import (
        HybridParallelOptimizer)
    inner = getattr(optimizer, "_inner", optimizer)
    return isinstance(inner, HybridParallelOptimizer)


def _split_over_mp(model) -> bool:
    """Whether ``model`` holds mp layers built split over more than one
    rank (a tensor-parallel model)."""
    from ..distributed.fleet.meta_parallel.parallel_layers import mp_layers
    kinds = (mp_layers.VocabParallelEmbedding,
             mp_layers.ColumnParallelLinear, mp_layers.RowParallelLinear)
    return any(isinstance(m, kinds) and m.world_size > 1
               for m in model.modules())


class _DataShard:
    """This rank's rows of the global batch along the mesh's data axes
    (and its sequence chunk along ``sep`` / ``cp``), and the group that
    averages over them."""

    def __init__(self, mesh, batch_spec, model, optimizer=None):
        shape = mesh.shape
        later = {a: d for a, d in shape.items() if a in _LATER_AXES and d > 1}
        if later:
            raise NotImplementedError(
                f"mesh axes {later}: a pipeline trains through "
                "PipelineParallel.train_batch or gpt_pipeline_step / "
                "llama_pipeline_step, not this step")
        seq = {a: d for a, d in shape.items() if a in ("sep", "cp") and d > 1}
        if len(seq) > 1:
            raise NotImplementedError("sep and cp together: one sequence "
                                      "axis at a time")
        self.seq_n, self.seq_index = 1, 0
        if seq:
            (axis, self.seq_n), = seq.items()
            self.seq_index = mesh.group(axis).rank
        # mp layers built split, or a sequence axis: the hybrid optimizer
        # reduces; a plain or semi-auto model takes DataParallel
        tp = bool(seq) or (shape.get("mp", 1) > 1 and (
            (optimizer is not None and _hybrid(optimizer))
            or _split_over_mp(model)))
        if batch_spec is not None:
            spec = list(batch_spec)
            if any(s is not None for s in spec[1:]):
                raise NotImplementedError(
                    f"batch_spec {batch_spec}: only the batch dimension is "
                    "sharded (sequence sharding waits for slice (c))")
            lead = spec[0] if spec else None
            axes = () if lead is None else tuple(
                lead if isinstance(lead, (tuple, list)) else (lead,))
        else:
            axes = tuple(a for a in ("dp", "sharding") if shape.get(a, 1) > 1)
        self.n = int(np.prod([shape[a] for a in axes])) if axes else 1
        self.group, self.index, self._dp = None, 0, None
        if self.n > 1:
            from ..distributed.parallel import DataParallel, reducer_of
            self.group = mesh.group(axes)
            self.index = self.group.rank
            p0 = next((p for p in model.parameters() if p.requires_grad),
                      None)
            red = reducer_of(p0) if p0 is not None else None
            if red is None and tp:
                if optimizer is not None and not _hybrid(optimizer):
                    raise ValueError(
                        "a tensor-parallel model's gradients are reduced by "
                        "HybridParallelOptimizer: build the optimizer with "
                        "fleet.distributed_optimizer")
            elif red is None:
                self._dp = DataParallel(model, group=self.group)
            elif red.group.ranks != self.group.ranks:
                raise ValueError(f"the model's reducer averages over ranks "
                                 f"{red.group.ranks}, the mesh's data axes "
                                 f"are {self.group.ranks}")

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 0:
            return x
        if self.n > 1:
            b = x.shape[0]
            if b % self.n:
                raise ValueError(f"global batch {b} does not split over "
                                 f"{self.n} data ranks")
            k = b // self.n
            x = x[self.index * k:(self.index + 1) * k]
        if self.seq_n > 1 and x.dim() >= 2:
            s = x.shape[1]
            if s % self.seq_n:
                raise ValueError(f"sequence {s} does not split over "
                                 f"{self.seq_n} sep / cp ranks")
            k = s // self.seq_n
            x = x[:, self.seq_index * k:(self.seq_index + 1) * k]
        return x

    def prepare(self) -> None:
        if self._dp is not None:
            self._dp._reducer.sync_layout()

    def release(self) -> None:
        """Take the DataParallel this shard built off the model (its
        gradient hooks and bucket views)."""
        if self._dp is not None:
            self._dp._reducer.detach()
            self._dp = None

    def mean(self, loss: torch.Tensor) -> torch.Tensor:
        """The ranks' losses averaged in fp32, in the loss's dtype."""
        if self.n == 1:
            return loss
        from ..distributed.communication import ReduceOp, all_reduce
        total = loss.float()
        all_reduce(total, op=ReduceOp.AVG, group=self.group)
        return total.to(loss.dtype)


class TrainStep:
    """The reference's parameters in its order.  ``mesh`` and
    ``batch_spec`` shard the global batch over the data axes (module
    docstring); ``batch_spec`` is read only with a mesh, as in the
    reference, and may shard dimension 0 only.  A ``pp`` mesh axis of
    degree above 1 raises ``NotImplementedError``.
    ``donate`` changes nothing here (the eager step updates the
    parameters in place either way)."""

    def __init__(self, model, loss_fn=None, optimizer=None, scaler=None,
                 mesh=None, batch_spec=None, step_fn=None,
                 donate: bool = True):
        if loss_fn is None and step_fn is None:
            raise ValueError("give loss_fn or step_fn")
        if any(getattr(p, "_dist_attr", None) is not None
               for p in model.parameters()):
            from ..distributed.auto_parallel.api import check_placements
            check_placements(model)
        self._data = _DataShard(mesh, batch_spec, model, optimizer) \
            if mesh is not None else None
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.scaler = scaler
        self.step_fn = step_fn
        model.train()

    def _to_device(self, x):
        dev = next(self.model.parameters()).device
        if isinstance(x, torch.Tensor):
            return x.to(dev)
        return torch.as_tensor(np.asarray(x), device=dev)

    def __call__(self, *batch):
        batch = [self._to_device(b) for b in batch]
        if self._data is not None:
            batch = [self._data.rows(b) for b in batch]
            self._data.prepare()
        if self.step_fn is not None:
            loss = self.step_fn(self.model, *batch)
        else:
            loss = self.loss_fn(self.model(batch[0]), *batch[1:])
        if self.optimizer is not None:
            if self.scaler is not None:
                self.scaler.scale(loss).backward()
                self.scaler.step(self.optimizer)
                self.scaler.update()
            else:
                loss.backward()
                self.optimizer.step()
            self.optimizer.clear_grad()
        loss = loss.detach()
        return self._data.mean(loss) if self._data is not None else loss

    def release(self) -> None:
        """Take what the step attached to the model off it (the
        DataParallel it built over the data axes), so that another step
        may lay the model out anew."""
        if self._data is not None:
            self._data.release()


def train_step(model, loss_fn=None, optimizer=None, scaler=None,
               mesh=None, **kwargs) -> TrainStep:
    """Build the training step of ``model``: ``step_fn(model, *batch)``
    returns the loss (or ``loss_fn(model(batch[0]), *batch[1:])`` does);
    the model is put in training mode; ``scaler`` scales the loss and
    steps the optimizer (module docstring).  ``kwargs`` are
    :class:`TrainStep`'s (``batch_spec``, ``step_fn``, ``donate``)."""
    return TrainStep(model, loss_fn, optimizer, scaler, mesh=mesh, **kwargs)
