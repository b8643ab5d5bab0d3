"""Pass registration and management; counterpart of
``paddle_tpu/distributed/passes/pass_base.py`` (ref:
distributed/passes/pass_base.py ``PassBase``/``PassManager``/``new_pass``/
``register_pass``).

The program passes of ``static.passes`` register through this machinery,
so a pass's ``_incompatible`` list and ``new_pass`` names work across
both families (``program_remat_hints`` declares itself incompatible with
the recompute pass).  The distributed passes are the reference's
strategy-lowered ones: each maps onto ``fleet.DistributedStrategy``'s
knobs; gradient merge is a real transform (it wraps the context's
optimizer in ``GradientMergeOptimizer``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

__all__ = ["PASS_REGISTRY", "register_pass", "PassContext", "PassBase",
           "new_pass", "PassManager", "AMPPass", "FP16Pass", "RecomputePass",
           "ShardingPass", "GradientMergePass", "FuseAllReducePass",
           "FusedAttentionPass", "FusedFeedForwardPass"]

PASS_REGISTRY: Dict[str, type] = {}


def register_pass(name: str):
    """ref: pass_base.py register_pass decorator."""
    def deco(cls):
        cls.name = name
        PASS_REGISTRY[name] = cls
        return cls
    return deco


class PassContext:
    """ref: pass_base.py PassContext — carries cross-pass state: the
    strategy whose knobs a pass maps onto, the optimizer a pass may wrap,
    the passes applied so far and free-form ``attrs``."""

    def __init__(self, strategy=None, optimizer=None):
        self.strategy = strategy
        self.optimizer = optimizer
        self._applied: List["PassBase"] = []
        self.attrs: Dict[str, Any] = {}

    @property
    def passes(self):
        return list(self._applied)


class PassBase:
    """ref: pass_base.py PassBase — check_applicable + apply."""

    name = "base"
    # passes this one cannot be stacked with (checked against the passes
    # already applied in the context)
    _incompatible: List[str] = []

    def __init__(self):
        self._attrs: Dict[str, Any] = {}

    def set_attr(self, key: str, value):
        self._attrs[key] = value
        return self

    def get_attr(self, key: str, default=None):
        return self._attrs.get(key, default)

    def _check_self(self) -> bool:
        return True

    def _check_conflict(self, other: "PassBase") -> bool:
        return other.name not in self._incompatible

    def _apply_single_impl(self, main_program, startup_program,
                           context: PassContext):
        raise NotImplementedError

    def apply(self, main_programs, startup_programs,
              context: Optional[PassContext] = None) -> PassContext:
        context = context or PassContext()
        if not self._check_self():
            raise ValueError(f"pass {self.name!r} failed its self-check")
        for other in context.passes:
            if not self._check_conflict(other):
                raise ValueError(
                    f"pass {self.name!r} conflicts with already-applied "
                    f"{other.name!r}")
        mains = main_programs if isinstance(main_programs, (list, tuple)) \
            else [main_programs]
        starts = startup_programs if isinstance(startup_programs,
                                                (list, tuple)) \
            else [startup_programs]
        for m, s in zip(mains, list(starts) + [None] * (len(mains) -
                                                        len(starts))):
            self._apply_single_impl(m, s, context)
        context._applied.append(self)
        return context


def new_pass(name: str, pass_attrs: Optional[Dict[str, Any]] = None) \
        -> PassBase:
    """ref: pass_base.py new_pass(name, attrs)."""
    cls = PASS_REGISTRY.get(name)
    if cls is None and name.startswith("program_"):
        # the program passes register when static.passes is imported
        import paddle_tpu_torch.static.passes  # noqa: F401
        cls = PASS_REGISTRY.get(name)
    if cls is None:
        raise ValueError(
            f"unknown pass {name!r}; registered: {sorted(PASS_REGISTRY)}")
    p = cls()
    for k, v in (pass_attrs or {}).items():
        p.set_attr(k, v)
    return p


class PassManager:
    """ref: pass_base.py PassManager — ordered application."""

    def __init__(self, passes: Optional[List[PassBase]] = None):
        self._passes = list(passes or [])

    def add(self, p: PassBase):
        self._passes.append(p)

    @property
    def names(self):
        return [p.name for p in self._passes]

    def apply(self, main_programs, startup_programs,
              context: Optional[PassContext] = None) -> PassContext:
        context = context or PassContext()
        for p in self._passes:
            p.apply(main_programs, startup_programs, context)
        return context


# ---------------------------------------------------------------------------
# the knob-mapping passes (strategy-lowered, as in the reference)
# ---------------------------------------------------------------------------

@register_pass("auto_parallel_amp")
class AMPPass(PassBase):
    """ref: auto_parallel_amp.py — lowered to the amp strategy knobs
    (``amp.auto_cast`` / ``amp.decorate`` are the runtime mechanism)."""

    def _apply_single_impl(self, main_program, startup_program, context):
        if context.strategy is not None:
            context.strategy.amp = True
            for k, v in self._attrs.items():
                if k in context.strategy.amp_configs:
                    context.strategy.amp_configs[k] = v
        context.attrs["amp"] = dict(self._attrs) or {"enable": True}


@register_pass("auto_parallel_fp16")
class FP16Pass(AMPPass):
    """ref: auto_parallel_fp16.py — pure-fp16 == amp O2."""

    def _apply_single_impl(self, main_program, startup_program, context):
        super()._apply_single_impl(main_program, startup_program, context)
        if context.strategy is not None:
            context.strategy.amp_configs["use_pure_fp16"] = True


@register_pass("auto_parallel_recompute")
class RecomputePass(PassBase):
    """ref: auto_parallel_recompute.py — lowered to the strategy's
    recompute knob (and its ``checkpoints``), which the models read as
    ``use_recompute`` (``torch.utils.checkpoint`` per block)."""

    def _apply_single_impl(self, main_program, startup_program, context):
        if context.strategy is not None:
            context.strategy.recompute = True
            cps = self.get_attr("checkpoints")
            if cps is not None:
                context.strategy.recompute_configs["checkpoints"] = cps
        context.attrs["recompute"] = True


@register_pass("auto_parallel_sharding")
class ShardingPass(PassBase):
    """ref: auto_parallel_sharding.py — lowered to the sharding knobs
    (``stage``, ``sharding_degree``) of the strategy."""

    def _apply_single_impl(self, main_program, startup_program, context):
        if context.strategy is not None:
            context.strategy.sharding = True
            for k in ("stage", "sharding_degree", "degree"):
                v = self.get_attr(k)
                if v is not None:
                    key = "sharding_degree" if k == "degree" else k
                    context.strategy.sharding_configs[key] = v
        context.attrs["sharding"] = dict(self._attrs)


@register_pass("auto_parallel_gradient_merge_pass")
class GradientMergePass(PassBase):
    """ref: auto_parallel_gradient_merge.py — a real transform: wraps the
    context's optimizer in k-step gradient accumulation."""

    def _apply_single_impl(self, main_program, startup_program, context):
        from .gradient_merge import GradientMergeOptimizer
        k = int(self.get_attr("k_steps", 1))
        avg = bool(self.get_attr("avg", True))
        if context.strategy is not None:
            context.strategy.gradient_merge = True
            context.strategy.gradient_merge_configs["k_steps"] = k
            context.strategy.gradient_merge_configs["avg"] = avg
        if context.optimizer is not None and k > 1:
            context.optimizer = GradientMergeOptimizer(context.optimizer,
                                                       k_steps=k, avg=avg)
        context.attrs["gradient_merge"] = {"k_steps": k, "avg": avg}


def _make_schedule_pass(mode: str):
    @register_pass(f"pipeline_scheduler_{mode}")
    class _SchedulePass(PassBase):
        """ref: pipeline_scheduler_pass.py — records the schedule mode in
        the strategy (pipelines wait for a later slice)."""

        _mode = mode

        def _apply_single_impl(self, main_program, startup_program,
                               context):
            if context.strategy is not None:
                context.strategy.pipeline = True
                context.strategy.pipeline_configs["schedule_mode"] = \
                    self._mode
            context.attrs["pipeline_schedule"] = self._mode
    return _SchedulePass


for _mode in ("FThenB", "1F1B", "VPP", "ZBH1", "ZBVPP"):
    _make_schedule_pass(_mode)


@register_pass("fuse_all_reduce")
class FuseAllReducePass(PassBase):
    """ref: fuse_all_reduce.py — satisfied by construction: DataParallel's
    reducer all-reduces flat buckets of gradients; recorded for API
    parity."""

    def _apply_single_impl(self, main_program, startup_program, context):
        context.attrs["fuse_all_reduce"] = True


@register_pass("fused_attention")
class FusedAttentionPass(PassBase):
    """ref: fused_attention_pass — the flash attention kernels (K1)
    implement it; recorded for API parity."""

    def _apply_single_impl(self, main_program, startup_program, context):
        context.attrs["fused_attention"] = True


@register_pass("fused_feedforward")
class FusedFeedForwardPass(FusedAttentionPass):
    def _apply_single_impl(self, main_program, startup_program, context):
        context.attrs["fused_feedforward"] = True
