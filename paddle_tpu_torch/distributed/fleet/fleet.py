"""The Fleet singleton; counterpart of
``paddle_tpu/distributed/fleet/fleet.py`` (ref:
``python/paddle/distributed/fleet/fleet.py``).

``fleet.init`` joins the process group (``init_parallel_env``) and
builds the hybrid topology's rank grid and groups;
``distributed_model`` / ``distributed_optimizer`` wrap per enabled axis,
as the reference chooses: ``PipelineParallel`` for a ``PipelineLayer``
when the pipeline degree is above 1, else ``TensorParallel`` when a
model, sep or context degree is above 1, else ``DataParallel`` over the
dp x sharding group (under an expert degree the ranks of one ep group
hold different experts, so every reduction and broadcast stays inside
the dp group), and ``HybridParallelOptimizer`` (ZeRO stage 1 when
the sharding degree is above 1; a pipeline stage's gradient sync), under
``GradientMergeOptimizer`` when the strategy merges gradients.
"""
from __future__ import annotations

from typing import Optional

from ..env import get_world_size
from ..parallel import DataParallel, init_parallel_env
from .base.distributed_strategy import DistributedStrategy
from .base.role_maker import PaddleCloudRoleMaker
from .base.topology import (CommunicateTopology, HybridCommunicateGroup,
                            _set_hcg)
from .meta_optimizers.dygraph_optimizer.hybrid_parallel_optimizer import (
    HybridParallelOptimizer)
from .meta_parallel.parallel_layers.pp_layers import PipelineLayer
from .meta_parallel.pipeline_parallel import PipelineParallel
from .meta_parallel.tensor_parallel import TensorParallel

__all__ = ["Fleet", "fleet"]


class Fleet:
    def __init__(self):
        self._role_maker: Optional[PaddleCloudRoleMaker] = None
        self._strategy: Optional[DistributedStrategy] = None
        self._hcg: Optional[HybridCommunicateGroup] = None
        self._is_initialized = False

    # ------------------------------------------------------------------
    def init(self, role_maker=None, is_collective: bool = True,
             strategy: Optional[DistributedStrategy] = None,
             log_level="INFO", *, device=None):
        """ref: ``fleet.init``: join the group (``init_parallel_env``;
        ``device="cpu"`` runs it on gloo) and build the topology from
        ``strategy.hybrid_configs`` (a ``dp_degree`` of -1 absorbs the
        ranks left).  A pipeline degree above 1 with a sharding, sep or cp
        degree above 1 raises ``NotImplementedError``, as does an expert
        degree above 1 with a pipeline, sharding, model, sep or cp degree
        above 1; ``is_collective=False`` (parameter servers) too."""
        if not is_collective:
            raise NotImplementedError("parameter-server mode "
                                      "(is_collective=False)")
        init_parallel_env(device=device)
        self._role_maker = role_maker or PaddleCloudRoleMaker(
            is_collective=is_collective)
        self._strategy = strategy or DistributedStrategy()
        hc = self._strategy.hybrid_configs
        n = get_world_size()
        degrees = {"data": hc["dp_degree"], "pipe": hc["pp_degree"],
                   "sharding": hc["sharding_degree"],
                   "sep": hc["sep_degree"],
                   "context": hc.get("cp_degree", 1) or 1,
                   "expert": hc.get("ep_degree", 1) or 1,
                   "model": hc["mp_degree"]}
        known = 1
        for k, v in degrees.items():
            if k != "data" and v:
                known *= v
        if degrees["data"] in (-1, 0, None):
            degrees["data"] = max(n // known, 1)
            hc["dp_degree"] = degrees["data"]
        names = list(degrees)
        topo = CommunicateTopology(names, [degrees[k] for k in names])
        self._hcg = HybridCommunicateGroup(topo)
        _set_hcg(self._hcg)
        self._is_initialized = True
        return self

    # ------------------------------------------------------------------
    def get_hybrid_communicate_group(self) -> HybridCommunicateGroup:
        return self._hcg

    def is_first_worker(self) -> bool:
        return self._role_maker._is_first_worker()

    def worker_index(self) -> int:
        return self._role_maker._worker_index()

    def worker_num(self) -> int:
        return self._role_maker._worker_num()

    def is_worker(self) -> bool:
        return True

    def worker_endpoints(self, to_string: bool = False):
        eps = self._role_maker._get_trainer_endpoints()
        return ",".join(eps) if to_string else eps

    def server_num(self) -> int:
        return 0

    def barrier_worker(self):
        from ..communication import barrier
        barrier()

    @property
    def distributed_strategy(self) -> DistributedStrategy:
        return self._strategy

    # ------------------------------------------------------------------
    def distributed_model(self, model):
        """ref: ``fleet.py`` distributed_model: ``PipelineParallel`` for
        a ``PipelineLayer`` when the pipeline degree is above 1, else
        ``TensorParallel`` when the model, sep or context degree is above
        1, else ``DataParallel`` over the dp x sharding group when either
        degree is above 1, else the model itself.  A model that is not a
        ``PipelineLayer`` trains under pipelines through
        ``gpt_pipeline_step`` / ``llama_pipeline_step``."""
        hcg = self._hcg
        if hcg.get_pipe_parallel_world_size() > 1 and \
                isinstance(model, PipelineLayer):
            return PipelineParallel(model, hcg, self._strategy)
        if hcg.get_model_parallel_world_size() > 1 or \
                hcg.get_sep_parallel_world_size() > 1 or \
                hcg.get_context_parallel_world_size() > 1:
            return TensorParallel(model, hcg, self._strategy)
        if hcg.get_data_parallel_world_size() > 1 or \
                hcg.get_sharding_parallel_world_size() > 1:
            return DataParallel(model,
                                find_unused_parameters=self._strategy
                                .find_unused_parameters,
                                group=hcg.get_dp_sharding_parallel_group())
        return model

    def distributed_optimizer(self, optimizer, strategy=None):
        """ref: ``fleet.py`` distributed_optimizer: the hybrid optimizer,
        inside a gradient-merge window when the strategy asks for one."""
        if strategy is not None:
            self._strategy = strategy
        from ..passes.gradient_merge import GradientMergeOptimizer
        s = self._strategy
        k, avg = 1, True
        if isinstance(optimizer, GradientMergeOptimizer):
            # already merge-wrapped: unwrap so the hybrid optimizer sits
            # INSIDE the merge window (a second wrap would square it)
            k, avg = optimizer.k_steps, optimizer.avg
            optimizer = optimizer._inner
        if s is not None and getattr(s, "gradient_merge", False):
            k = max(k, int(s.gradient_merge_configs.get("k_steps", 1)))
            avg = bool(s.gradient_merge_configs.get("avg", avg))
        opt = HybridParallelOptimizer(optimizer, self._hcg, self._strategy)
        if k > 1:
            if s is not None and getattr(s, "amp", False):
                raise ValueError(
                    "strategy.gradient_merge with strategy.amp is not "
                    "supported: GradScaler unscales the ACCUMULATED grad "
                    "buffer on every micro-step, corrupting the merge "
                    "window")
            return GradientMergeOptimizer(opt, k_steps=k, avg=avg)
        return opt

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        raise NotImplementedError(
            "static-graph fleet.minimize: use fleet.distributed_optimizer "
            "in dygraph mode")


fleet = Fleet()
