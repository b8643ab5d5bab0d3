"""PipelineParallel, the model wrapper and its micro-batch loop; counterpart
of ``paddle_tpu/distributed/fleet/meta_parallel/pipeline_parallel.py``
(ref: ``fleet/meta_parallel/pipeline_parallel.py``).

``train_batch`` takes the global batch, as the JAX package's does: it
splits it into ``accumulate_steps`` micro-batches along dimension 0 and,
under a data-parallel degree above 1, each micro-batch's rows over the dp
group (rank r of n keeps its n-th).  The schedule (``schedule_mode``:
FThenB, 1F1B, VPP, ZBH1) runs on this rank's stage over p2p
(``pp_schedules.P2PPipelineSchedule``) when the fleet topology has a
pipeline degree above 1, or every stage in this process
(``HostPipelineSchedule``) when this process holds the whole
``PipelineLayer``.  After the last micro-batch's backward the optimizer
step sums the shared layers' weight gradients over their stages and
averages every gradient over the stage's dp group, once
(``HybridParallelOptimizer``; a bare optimizer is refused when that
average or a shared weight is needed).  The loss exists on the last stage:
``train_batch`` averages it (the micro-batches' mean, in fp32) over dp
and broadcasts it over the pipeline group, so every rank returns it.

The JAX package's rules for when a schedule cannot run as asked are
kept, behind ``FLAGS_pp_allow_axis_fallback``: with a live mp axis an
explicitly chosen schedule raises ``RuntimeError`` unless the flag is
set (then it warns, and each mp rank runs the whole stage: a
``PipelineLayer``'s layers are not split by mp; ``llama_pipeline_step``
/ ``gpt_pipeline_step`` run the mp layers); a micro-batch whose rows do
not split over dp warns and runs on every dp rank whole.  With a
``GradScaler`` the schedule still runs (the JAX package falls back to a
grad-accumulation loop): each micro-batch's loss is scaled on the last
stage, and ``scaler.step`` and ``update`` run once, after the last
backward and the gradient reductions (the scaler's flag is reduced over
every rank, pp included); a multi-input model runs its schedule (the
first stage takes the tuple), so nothing is bypassed.  Sharding, sep
and cp with pp raise at ``fleet.init``.
"""
from __future__ import annotations

import warnings
from typing import Optional

import torch

from ...communication.collective_ops import all_reduce, broadcast
from ...communication.group import ReduceOp
from .parallel_layers.pp_layers import PipelineLayer
from .tensor_parallel import MetaParallelBase

__all__ = ["PipelineParallel"]


class PipelineParallel(MetaParallelBase):
    """ref: ``PipelineParallel`` (module docstring)."""

    def __init__(self, layers, hcg=None, strategy=None):
        if not isinstance(layers, PipelineLayer):
            raise TypeError(
                "PipelineParallel expects a PipelineLayer (ref: same check)")
        super().__init__(layers, hcg, strategy)
        cfg = (strategy.pipeline_configs if strategy is not None else None)
        self.micro_batch_size = cfg["micro_batch_size"] if cfg else 1
        self.accumulate_steps = cfg["accumulate_steps"] if cfg else 1
        self.schedule_mode = cfg.get("schedule_mode", "1F1B") if cfg \
            else "1F1B"
        self._cache_shape = bool(cfg.get("p2p_cache_shape", True)) if cfg \
            else True
        # whether the user chose the schedule (the default counts, as in
        # the JAX package: the strategy's configs carry one)
        self._schedule_explicit = bool(cfg and "schedule_mode" in cfg)
        self.total_loss = None
        self._host_sched = None
        self._dp = 1

    @torch.no_grad()
    def _prepare_for_model(self):
        from ..utils.hybrid_parallel_util import (broadcast_dp_parameters,
                                                  broadcast_mp_parameters)
        if self._hcg is not None:
            broadcast_mp_parameters(self._layers, self._hcg)
            broadcast_dp_parameters(self._layers, self._hcg)

    def _distributed(self) -> bool:
        return self._hcg is not None and \
            self._hcg.get_pipe_parallel_world_size() > 1

    def _split_micro(self, data, n):
        if isinstance(data, (tuple, list)):
            parts = [self._split_micro(d, n) for d in data]
            return list(zip(*parts))
        b = data.shape[0]
        if b % n:
            raise ValueError(f"batch {b} does not split into "
                             f"{n} micro-batches")
        mb = b // n
        return [data[i * mb:(i + 1) * mb] for i in range(n)]

    def _scheduler(self, microbatch_size=None):
        """This rank's schedule, built on first use (the rules of
        the module docstring)."""
        if self._host_sched is not None:
            return self._host_sched
        h = self._hcg
        dp = 1
        if h is not None:
            dp = h.get_data_parallel_world_size()
            if h.get_model_parallel_world_size() > 1:
                from ....flags import get_flag
                if self._schedule_explicit and \
                        not get_flag("pp_allow_axis_fallback"):
                    raise RuntimeError(
                        f"schedule_mode={self.schedule_mode!r} was "
                        "explicitly requested, but axes ['model'] are "
                        "live and a PipelineLayer's stages are not split "
                        "by mp: each mp rank would run the whole stage.  "
                        "Use models.llama.llama_pipeline_step / "
                        "pp_spmd.gpt_pipeline_step, whose stages run the "
                        "mp layers, or set FLAGS_pp_allow_axis_fallback=1 "
                        "to accept it")
                warnings.warn(
                    "pipeline: axes ['model'] are live; a "
                    "PipelineLayer's stages run whole on each mp rank "
                    "(the pipeline steps split them)")
        if dp > 1 and microbatch_size is not None \
                and microbatch_size % dp != 0:
            warnings.warn(
                f"pipeline: microbatch size {microbatch_size} is "
                f"not divisible by dp_degree={dp}; each dp rank runs the "
                "whole micro-batch")
            dp = 1
        self._dp = dp
        from .pp_schedules import HostPipelineSchedule, P2PPipelineSchedule
        if self._distributed():
            self._host_sched = P2PPipelineSchedule(
                self._layers, schedule_mode=self.schedule_mode, hcg=h,
                cache_shape=self._cache_shape)
        else:
            self._host_sched = HostPipelineSchedule(
                self._layers, schedule_mode=self.schedule_mode)
        return self._host_sched

    def _device(self):
        p = next(self._layers.parameters(), None)
        return p.device if p is not None else torch.device("cpu")

    def _rows(self, t, dp):
        """This dp rank's rows of one micro-batch (on the stage's
        device)."""
        t = torch.as_tensor(t).to(self._device())
        if dp == 1:
            return t
        k = t.shape[0] // dp
        r = self._hcg.get_data_parallel_rank()
        return t[r * k:(r + 1) * k]

    def forward_backward_pipeline(self, data, scaler=None):
        """The micro-batch loop under the schedule (module docstring);
        returns the mean loss (on every rank under a topology)."""
        inputs, labels = data
        n = self.accumulate_steps
        micro_inputs = self._split_micro(inputs, n)
        micro_labels = self._split_micro(labels, n)
        first = micro_inputs[0]
        mb = (first[0] if isinstance(first, tuple) else first).shape[0]
        sched = self._scheduler(microbatch_size=mb)
        dp = self._dp

        def rows(x):
            return tuple(self._rows(t, dp) for t in x) \
                if isinstance(x, tuple) else self._rows(x, dp)
        xs = [rows(x) for x in micro_inputs]
        ys = [rows(y) for y in micro_labels]
        sched.loss_scale = scaler._on(self._device()) \
            if scaler is not None and scaler.is_enable() else None
        loss = sched.forward_backward(xs, ys)
        if self._distributed():
            loss = self._broadcast_loss(loss)
        self.total_loss = loss
        return loss

    def _broadcast_loss(self, loss: Optional[torch.Tensor]) -> torch.Tensor:
        """The last stage's fp32 loss averaged over dp and sent to every
        stage."""
        h = self._hcg
        buf = torch.zeros(1, dtype=torch.float32, device=self._device())
        if h.is_last_stage():
            buf[0] = loss.float()
            if self._dp > 1:
                all_reduce(buf, op=ReduceOp.AVG,
                           group=h.get_data_parallel_group())
        broadcast(buf, src=h.get_rank_from_stage(
            h.get_pipe_parallel_world_size() - 1),
            group=h.get_pipe_parallel_group())
        return buf[0]

    def _check_optimizer(self, optimizer) -> None:
        from ..meta_optimizers.dygraph_optimizer.hybrid_parallel_optimizer \
            import HybridParallelOptimizer
        inner = getattr(optimizer, "_inner", optimizer)
        if isinstance(inner, HybridParallelOptimizer):
            return
        need = (self._dp > 1 or self._layers.shared_weights()) \
            and self._distributed()
        if need:
            raise ValueError(
                "a pipeline's gradients are averaged over dp (and shared "
                "weights' summed over their stages) by "
                "HybridParallelOptimizer: build the optimizer with "
                "fleet.distributed_optimizer")

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """ref: ``PipelineParallel.train_batch``."""
        self._layers.train()
        loss = self.forward_backward_pipeline(data, scaler)
        self._check_optimizer(optimizer)
        if scaler is not None:
            scaler.step(optimizer)
            scaler.update()
        else:
            optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return loss

    @torch.no_grad()
    def eval_batch(self, data, compute_loss: bool = True):
        """The forward of every stage in this process (the whole
        ``PipelineLayer``); under a pipeline degree above 1 it raises
        ``NotImplementedError`` (evaluation over p2p waits for a later
        slice)."""
        if self._distributed():
            raise NotImplementedError("eval_batch under a pipeline degree "
                                      "above 1 waits for a later slice")
        self._layers.eval()
        inputs, labels = data
        out = self._layers(torch.as_tensor(inputs).to(self._device()))
        if compute_loss:
            return self._layers._loss_fn(
                out, torch.as_tensor(labels).to(self._device()))
        return out

