"""Global flag registry with ``FLAGS_*`` environment ingestion; a copy of
the registry of ``paddle_tpu/flags.py`` holding only the flags the port
reads.

``define_flag`` registers a typed flag and takes its value from the
``FLAGS_<name>`` environment variable when one is set;
``set_flags`` / ``get_flags`` have the reference's call signatures.  The
JAX package's flags that configure JAX (transfer guard, the XLA
compilation cache) and those of unported subsystems are not defined
here; ``tuning_cache_dir`` names the tuning cache's directory
(``tuning.cache``, ``tuning.learned``) without the reference's XLA
compilation cache.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Union

__all__ = ["define_flag", "get_flag", "get_flags", "set_flags"]


@dataclass
class _Flag:
    name: str
    default: Any
    type: type
    help: str
    value: Any = None
    on_change: Optional[Callable[[Any], None]] = None


_REGISTRY: Dict[str, _Flag] = {}


def _coerce(ftype: type, raw: Any) -> Any:
    if isinstance(raw, str) and ftype is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    return ftype(raw)


def define_flag(name: str, default: Any, help: str = "",
                on_change: Optional[Callable[[Any], None]] = None) -> None:
    """Register a flag. ``name`` may be given with or without the FLAGS_ prefix."""
    if not name.startswith("FLAGS_"):
        name = "FLAGS_" + name
    ftype = type(default)
    flag = _Flag(name=name, default=default, type=ftype, help=help,
                 on_change=on_change)
    env = os.environ.get(name)
    flag.value = _coerce(ftype, env) if env is not None else default
    _REGISTRY[name] = flag
    if env is not None and on_change is not None:
        try:
            on_change(flag.value)   # env override takes effect at import
        except Exception as e:      # a typo'd env var must not brick import
            import warnings
            warnings.warn(f"ignoring invalid {name}={env!r}: {e}")
            flag.value = default


def get_flags(flags: Union[str, Iterable[str], None] = None) -> Dict[str, Any]:
    """Query flag values. Mirrors ``paddle.get_flags``."""
    if flags is None:
        names: List[str] = list(_REGISTRY)
    elif isinstance(flags, str):
        names = [flags]
    else:
        names = list(flags)
    out = {}
    for n in names:
        key = n if n.startswith("FLAGS_") else "FLAGS_" + n
        if key not in _REGISTRY:
            raise ValueError(f"unknown flag {n!r}")
        out[n] = _REGISTRY[key].value
    return out


def set_flags(flags: Dict[str, Any]) -> None:
    """Set flag values. Mirrors ``paddle.set_flags``."""
    for n, v in flags.items():
        key = n if n.startswith("FLAGS_") else "FLAGS_" + n
        if key not in _REGISTRY:
            raise ValueError(f"unknown flag {n!r}")
        f = _REGISTRY[key]
        new = _coerce(f.type, v)
        # validate via on_change BEFORE committing: a rejected value
        # must not leave the registry diverged from actual behavior
        if f.on_change is not None:
            f.on_change(new)
        f.value = new


def get_flag(name: str) -> Any:
    key = name if name.startswith("FLAGS_") else "FLAGS_" + name
    return _REGISTRY[key].value


define_flag("serving_engine", False,
            "route InferenceServer POST /generate through the "
            "continuous-batching ServingEngine (paddle_tpu_torch."
            "serving): iteration-level admission, ragged paged "
            "attention, prefix-cache sharing, per-request token "
            "streaming.  Off: the endpoint answers 404")
define_flag("serving_fused_steps", 1,
            "serving engine: run up to N ragged decode iterations as ONE "
            "window with a single host read (models.generation."
            "build_fused_window_step).  EOS/budget tracking, page-append "
            "cursors and sampling stay on the device; once a sequence "
            "finishes, the window's remaining iterations do nothing.  1 "
            "(the default) keeps one read per step; prefill and "
            "eviction-pressured steps always run the single-step path")
# read on every collective entry by distributed.communication.sanitizer
# (no on_change hook: toggling it mid-run takes effect at the next call)
define_flag("collective_sanitizer", False,
            "cross-check order/shape/dtype/reduce-op fingerprints of "
            "every collective across the group's ranks (through the "
            "process group's store) before launching it; on mismatch "
            "raise CollectiveMismatchError with both ranks' fingerprint "
            "streams (instead of the hang) and emit a "
            "collective_mismatch event.  See paddle_tpu_torch."
            "distributed.communication.sanitizer")
# read by fleet.meta_parallel.pipeline_parallel when a schedule is chosen
define_flag("pp_allow_axis_fallback", False,
            "allow an EXPLICIT pipeline schedule_mode to run with a live "
            "mp axis that the PipelineLayer's stages do not split (each "
            "mp rank then runs the whole stage; default: raise — use "
            "llama_pipeline_step / gpt_pipeline_step, whose stages run "
            "the mp layers)")
# read lazily by observability.lockwatch.make_lock/make_rlock/
# make_condition at construction time: set it BEFORE building the
# engine or the server; already-constructed objects keep their stdlib
# locks
define_flag("lock_sanitizer", False,
            "instrument the serving tier's Lock/RLock/Condition "
            "objects: record per-thread held-lock sets, detect "
            "lock-order (wait-for) cycles at acquire time and raise "
            "LockOrderError naming both threads' hold stacks instead "
            "of deadlocking; emit lock_contention events past "
            "hold/wait thresholds and export paddle_lock_* metrics. "
            "See paddle_tpu_torch.observability.lockwatch")


def _apply_observability_dir(path: str):
    """The JSONL event log (paddle_tpu_torch.observability.events)
    lands under ``path``; empty disables it and every emit site
    degrades to a single is-None check.  The metrics registry is always
    live — this flag only gates the on-disk event stream."""
    from .observability import events
    events.configure(path or None)


define_flag("observability_dir", "",
            "directory for the structured event log (events.jsonl; see "
            "paddle_tpu_torch.observability); empty: disabled",
            on_change=_apply_observability_dir)


define_flag("tuning_cache_dir", "",
            "directory of the persistent tuning cache (<kind>.jsonl; "
            "paddle_tpu_torch.tuning.cache) and of the learned "
            "performance model (perf_model.json; paddle_tpu_torch."
            "tuning.learned), which predicted-cost serving admission, "
            "the fleet router and `python -m paddle_tpu_torch."
            "observability watchdog --perf-model` read; `python -m "
            "paddle_tpu_torch.tuning` manages it.  Empty: disabled.  The "
            "port compiles no XLA programs, so no compilation cache "
            "lives under it")

define_flag("learned_perf_model", True,
            "consult the learned performance model (perf_model.json "
            "under FLAGS_tuning_cache_dir; `python -m paddle_tpu_torch."
            "tuning fit --from-events`) for Engine.tune's plans: its "
            "plan head picks the winner with zero trial steps on a cold "
            "plan cache.  False forces measurement; no model file, or "
            "one without a plan head, measures either way")


def _apply_fault_schedule(text: str):
    """Deterministic chaos layer (paddle_tpu_torch.resilience.faults):
    parse and install the fault-injection schedule.  A malformed
    schedule raises here, so set_flags rejects it and an env typo warns
    at import instead of silently not injecting."""
    from .resilience.faults import install_schedule
    install_schedule(text)


define_flag("fault_schedule", "",
            "deterministic fault-injection schedule "
            "'point@N=kind[:arg];...' over the named fault points "
            "(step, ckpt_write, collective, compile, serving_step); "
            "kinds: crash, exit, stall, exc, truncate, corrupt, nan "
            "(nan: serving_step only — on-device NaN-logits poison). "
            "Empty: disabled.  See paddle_tpu_torch.resilience.faults",
            on_change=_apply_fault_schedule)
define_flag("serving_step_timeout_s", 0.0,
            "serving engine hung-step watchdog (seconds): >0 bounds "
            "every device dispatch (single step or fused window); on "
            "expiry the watchdog dumps the flight recorder, emits a "
            "step_timeout event, abandons the wedged loop thread "
            "(fresh device pools + page pool) and resumes every "
            "running stream via requeue-at-front — token-exact under "
            "deterministic decode, no stream silently truncated.  "
            "0 (default): disabled")
define_flag("serving_predicted_admission", 0.0,
            "per-iteration batch-step cost budget (seconds) for "
            "serving admission: >0 admits new prefills only while the "
            "learned perf model's predicted step cost stays under the "
            "budget (predicted_cost_s rides serving_admit events); "
            "0 or no trained batch_step head: raw page/token caps "
            "only")
