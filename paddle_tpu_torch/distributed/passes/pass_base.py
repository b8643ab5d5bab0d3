"""Pass registration and management; counterpart of
``paddle_tpu/distributed/passes/pass_base.py`` (ref:
distributed/passes/pass_base.py ``PassBase``/``PassManager``/``new_pass``/
``register_pass``).

The program passes of ``static.passes`` register through this machinery,
so a pass's ``_incompatible`` list and ``new_pass`` names work across
both families.  Of the distributed passes only the recompute pass is here
(``program_remat_hints`` declares itself incompatible with it); the AMP,
sharding, gradient-merge and schedule passes wait for ``distributed/``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

__all__ = ["PASS_REGISTRY", "register_pass", "PassContext", "PassBase",
           "new_pass", "PassManager", "RecomputePass"]

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
