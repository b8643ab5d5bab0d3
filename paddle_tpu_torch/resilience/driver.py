"""The resilient training driver; counterpart of
``paddle_tpu/resilience/driver.py``: the layer that joins
``distributed.fleet.elastic`` liveness, launcher-style supervision and
crash-safe checkpointing (``distributed.checkpoint``) into one
kill -> relaunch -> resume loop.

Two halves, one contract:

* **Supervisor** (:func:`run_resilient`) — spawns the training script
  under a :class:`LauncherInterface`, watches BOTH failure modes via an
  :class:`ElasticManager` (crash = nonzero exit, stall = stale progress
  heartbeat), relaunches with capped restarts + deterministic
  exponential backoff (:func:`restart_backoff`, which the fleet's
  replica supervisor shares), and handles SIGTERM preemption by
  forwarding the signal and granting the worker a grace window to write
  its final checkpoint.
* **Worker** (:class:`ResilientTrainLoop`) — the training-script side:
  restores from the newest *valid* (committed, digest-clean) checkpoint
  version, pings a progress heartbeat and fires the ``step`` fault
  point each step, saves versioned committed checkpoints with
  keep-last-K retention, and on SIGTERM writes a synchronous final
  checkpoint and exits cleanly.

A process of several ranks (``distributed.launch``) runs one loop a
rank: ``restore`` and ``save`` are collective calls there, as the
checkpoint's load and save are.
"""
from __future__ import annotations

import os
import signal
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

from .. import flags as _flags  # noqa: F401 — FLAGS_* env ingestion
from ..observability import events as obs_events
from ..observability import tracing as obs_tracing
from .faults import STATE_FILE_ENV, maybe_fault

__all__ = ["ResilientTrainLoop", "RunReport", "run_resilient",
           "restart_backoff", "CKPT_DIR_ENV"]

# the supervisor exports the checkpoint dir to workers under this name
# so one script serves both standalone and supervised runs
CKPT_DIR_ENV = "PADDLE_RESILIENT_CKPT_DIR"


def restart_backoff(restarts: int, base_delay: float,
                    max_delay: float) -> float:
    """Deterministic exponential backoff before the ``restarts``-th
    relaunch — shared by :func:`run_resilient` and the fleet replica
    supervisor (``serving.fleet.replica``) so chaos runs reproduce."""
    return min(float(max_delay),
               float(base_delay) * (2 ** (max(int(restarts), 1) - 1)))


# ---------------------------------------------------------------------------
# worker side
# ---------------------------------------------------------------------------

class ResilientTrainLoop:
    """Checkpoint/heartbeat/preemption harness for a training loop.

    ::

        loop = ResilientTrainLoop(ckpt_dir, model.state_dict,
                                  save_every=10, keep_last_k=3)
        for step in range(loop.restore(), total_steps):
            ...train...
            loop.end_step(step)
        loop.finish()

    ``state_dict`` is a dict of Tensors or a zero-arg callable returning
    one (pass the callable when the dict is rebuilt per step).  On
    SIGTERM (preemption) the next ``end_step`` writes a synchronous
    final checkpoint and raises ``SystemExit(0)`` — the supervisor sees
    a clean exit and does not relaunch.
    """

    def __init__(self, ckpt_dir: Optional[str] = None,
                 state_dict: Union[Dict[str, Any],
                                   Callable[[], Dict[str, Any]], None] = None,
                 *, save_every: int = 1, keep_last_k: Optional[int] = 3,
                 heartbeat: bool = True, heartbeat_interval: float = 0.5,
                 rank: Optional[int] = None,
                 on_preempt: Optional[Callable[[int], None]] = None):
        self.ckpt_dir = ckpt_dir or os.environ.get(CKPT_DIR_ENV)
        if not self.ckpt_dir:
            raise ValueError(
                f"no checkpoint dir: pass ckpt_dir or set {CKPT_DIR_ENV}")
        self._state_dict = state_dict
        self.save_every = int(save_every)
        self.keep_last_k = keep_last_k
        self.on_preempt = on_preempt
        self.preempted = False
        self.last_saved_step: Optional[int] = None
        self._prev_sigterm = None
        # signal handlers only install from the main thread; elsewhere
        # (tests driving the loop from a worker thread) preemption is
        # still reachable via request_preempt()
        if threading.current_thread() is threading.main_thread():
            self._prev_sigterm = signal.signal(
                signal.SIGTERM, self._on_sigterm)
        self._hb = None
        if heartbeat:
            from ..distributed.fleet.elastic import worker_heartbeat
            self._hb = worker_heartbeat(rank=rank,
                                        interval=heartbeat_interval,
                                        mode="progress")
            self._hb.ping()

    # -- preemption ------------------------------------------------------
    def _on_sigterm(self, signum, frame):
        self.preempted = True

    def request_preempt(self) -> None:
        """Programmatic preemption (the SIGTERM path without a signal)."""
        self.preempted = True

    # -- checkpointing ---------------------------------------------------
    def _sd(self) -> Dict[str, Any]:
        sd = self._state_dict() if callable(self._state_dict) \
            else self._state_dict
        if sd is None:
            raise ValueError("ResilientTrainLoop has no state_dict")
        return sd

    def restore(self) -> int:
        """Load the newest valid checkpoint version into the state dict
        and return the step to resume FROM (0 on a fresh start)."""
        from ..distributed import checkpoint as ckpt
        info = ckpt.latest_committed(self.ckpt_dir)
        if info is None:
            return 0
        ckpt.load_state_dict(self._sd(), self.ckpt_dir)
        loaded = ckpt.last_load_info() or {}
        meta = (loaded.get("metadata") or info[1].get("meta") or {})
        step = meta.get("step")
        self.last_saved_step = int(step) if step is not None else None
        return self.last_saved_step + 1 \
            if self.last_saved_step is not None else 0

    def save(self, step: int) -> None:
        """Synchronous committed save of version ``step`` (+ retention GC)."""
        from ..distributed import checkpoint as ckpt
        ckpt.save_state_dict(self._sd(), self.ckpt_dir, unique_id=step,
                             metadata={"step": int(step)},
                             keep_last_k=self.keep_last_k)
        self.last_saved_step = int(step)

    # -- the per-step hook ----------------------------------------------
    def end_step(self, step: int, *, loss: Optional[float] = None,
                 examples: Optional[float] = None) -> None:
        """Call once per completed training step: fires the ``step``
        fault point, emits the step telemetry record, advances the
        progress heartbeat, checkpoints every ``save_every`` steps, and
        honors a pending preemption.  ``loss``/``examples`` (this
        step's sample count) enrich the telemetry when given."""
        maybe_fault("step", step=step)
        # telemetry AFTER the fault point: a step whose fault crashed
        # the process never logs, so the event stream's step ids stay
        # strictly increasing across a relaunch-and-resume
        self._emit_step(step, loss, examples)
        if self._hb is not None:
            self._hb.ping()
        if self.preempted:
            # synchronous final checkpoint, then a CLEAN exit: the
            # supervisor must not relaunch a preempted worker.  The
            # flight recorder dumps the last-N events/spans alongside —
            # the post-mortem view of what the worker was doing when
            # SIGTERM landed
            self.save(step)
            obs_tracing.dump_flight("preempt")
            if self.on_preempt is not None:
                self.on_preempt(step)
            self._teardown()
            raise SystemExit(0)
        if self.save_every > 0 and (step + 1) % self.save_every == 0:
            self.save(step)

    def _emit_step(self, step: int, loss, examples) -> None:
        from ..observability import events, metrics
        if not events.enabled():
            return
        # interval since the previous end_step (None on the first step
        # of this process) — an anchor difference, routed straight into
        # the shared registry histogram + the event record
        now = time.perf_counter()  # noqa: PTL501 — the delta is
        # observed into observability.metrics two lines down
        anchor = getattr(self, "_t_last_step", None)
        self._t_last_step = now
        dt = (now - anchor) if anchor is not None else None
        if dt is not None:
            metrics.histogram(
                "paddle_train_step_seconds",
                "wall time between consecutive end_step calls",
                buckets=metrics.TIME_BUCKETS).observe(dt)
        events.emit(
            "step", step=int(step),
            loss=float(loss) if loss is not None else None,
            step_time_s=round(dt, 6) if dt is not None else None,
            examples_per_sec=round(float(examples) / dt, 3)
            if (examples and dt) else None)

    def finish(self, rank: Optional[int] = None) -> None:
        """Mark this worker completed (the elastic done-file) and stop
        the heartbeat."""
        from ..distributed.fleet.elastic import ElasticManager
        ElasticManager(np=1).mark_completed(rank)
        self._teardown()

    def _teardown(self) -> None:
        if self._hb is not None:
            self._hb.stop()
            self._hb = None
        if self._prev_sigterm is not None and \
                threading.current_thread() is threading.main_thread():
            signal.signal(signal.SIGTERM, self._prev_sigterm)
            self._prev_sigterm = None


# ---------------------------------------------------------------------------
# supervisor side
# ---------------------------------------------------------------------------

@dataclass
class RunReport:
    """What the supervised run actually did (chaos-test evidence)."""
    code: int = 1
    restarts: int = 0
    crashes: int = 0
    stalls: int = 0
    preempted: bool = False
    events: List[str] = field(default_factory=list)


def run_resilient(script: str, script_args: Optional[Sequence[str]] = None,
                  *, ckpt_dir: Optional[str] = None,
                  max_restarts: int = 5,
                  restart_backoff_s: float = 0.5,
                  max_backoff_s: float = 30.0,
                  heartbeat_timeout: float = 5.0,
                  stale_polls_to_restart: int = 2,
                  poll_interval: float = 0.1,
                  preempt_grace_s: float = 30.0,
                  log_dir: str = "log",
                  fault_schedule: Optional[str] = None,
                  env: Optional[Dict[str, str]] = None) -> RunReport:
    """Supervise ``script`` to completion through crashes and stalls.

    The worker script is expected to drive a :class:`ResilientTrainLoop`
    (or equivalent): resume from the newest valid checkpoint on start,
    ping a progress heartbeat per step, exit 0 when done.  The
    supervisor relaunches on crash (nonzero exit) or stall (stale
    heartbeat) up to ``max_restarts`` times with deterministic
    exponential backoff, and on SIGTERM forwards the preemption to the
    worker and waits ``preempt_grace_s`` for its final checkpoint.

    ``fault_schedule`` (chaos mode) is exported to workers as
    ``FLAGS_fault_schedule`` together with a job-scoped fired-state file
    so each scheduled fault fires exactly once across relaunches.
    """
    from ..distributed.fleet.elastic import (ElasticManager, ElasticStatus,
                                             LauncherInterface)
    os.makedirs(log_dir, exist_ok=True)
    child_env = dict(os.environ)
    if env:
        child_env.update(env)
    # make the framework importable in the worker even when it isn't
    # pip-installed (same torchrun-style propagation as launch/main.py)
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    pp = child_env.get("PYTHONPATH", "")
    if pkg_root not in pp.split(os.pathsep):
        child_env["PYTHONPATH"] = (pkg_root + os.pathsep + pp) if pp \
            else pkg_root
    if ckpt_dir:
        child_env[CKPT_DIR_ENV] = os.path.abspath(ckpt_dir)
    job_id = None
    if not child_env.get("PADDLE_ELASTIC_REGISTRY") and \
            not child_env.get("PADDLE_ELASTIC_JOB_ID"):
        job_id = f"resilient_{os.getpid()}_" \
            f"{int(time.time() * 1000)}"  # noqa: PTL501 — unique job
        # id, not a reported timing
        child_env["PADDLE_ELASTIC_JOB_ID"] = job_id
    if fault_schedule is not None:
        child_env["FLAGS_fault_schedule"] = fault_schedule
        child_env.setdefault(
            STATE_FILE_ENV,
            os.path.join(os.path.abspath(log_dir), "fault_state.txt"))
    rank = int(child_env.get("PADDLE_TRAINER_ID", "0"))

    manager = ElasticManager(ranks=[rank], job_id=job_id)
    manager.heartbeat_timeout = float(heartbeat_timeout)
    manager.stale_polls_to_restart = int(stale_polls_to_restart)
    child_env.setdefault("PADDLE_ELASTIC_REGISTRY", manager.registry)

    report = RunReport()
    cmd = [sys.executable, "-u", script] + list(script_args or [])
    log_path = os.path.join(log_dir, f"workerlog.{rank}")

    preempt = {"flag": False}
    prev_handler = None
    in_main = threading.current_thread() is threading.main_thread()
    if in_main:
        def _on_term(signum, frame):
            preempt["flag"] = True
        prev_handler = signal.signal(signal.SIGTERM, _on_term)

    try:
        while True:
            manager.reset()
            launcher = LauncherInterface()
            manager.launcher = launcher
            proc = launcher.launch(cmd, child_env, log_path)
            stalled = False
            code: Optional[int] = None
            while True:
                if preempt["flag"]:
                    # forward the preemption; give the worker its grace
                    # window to write the final checkpoint and exit 0
                    report.preempted = True
                    report.events.append("preempt:forward-sigterm")
                    obs_events.emit("preempt",
                                    grace_s=float(preempt_grace_s))
                    obs_tracing.dump_flight("preempt-supervisor")
                    try:
                        proc.send_signal(signal.SIGTERM)
                    except OSError:
                        pass
                    deadline = time.monotonic() + float(preempt_grace_s)
                    while proc.poll() is None and \
                            time.monotonic() < deadline:
                        time.sleep(poll_interval)
                    launcher.stop()
                    report.code = proc.poll() if proc.poll() is not None \
                        else 1
                    return report
                exit_status = launcher.watch()
                if exit_status is not None:
                    code = proc.poll() if proc.poll() is not None else 1
                    break
                if manager.enabled() and \
                        manager.watch() == ElasticStatus.RESTART:
                    stalled = True
                    launcher.stop()
                    code = 1
                    break
                time.sleep(poll_interval)
            launcher.stop()
            if code == 0 and not stalled:
                report.code = 0
                report.events.append("completed")
                return report
            if stalled:
                report.stalls += 1
                report.events.append("stall")
            else:
                report.crashes += 1
                report.events.append(f"crash:rc={code}")
            report.restarts += 1
            if report.restarts > max_restarts:
                report.code = code if code else 1
                report.events.append("gave-up")
                obs_events.emit("elastic_restart", reason="gave-up",
                                restarts=report.restarts,
                                code=int(code or 1))
                return report
            obs_events.emit("elastic_restart",
                            reason="stall" if stalled else "crash",
                            restarts=report.restarts,
                            code=int(code or 1))
            # deterministic exponential backoff — reproducible chaos runs
            time.sleep(restart_backoff(report.restarts,
                                       restart_backoff_s,
                                       max_backoff_s))
    finally:
        if in_main and prev_handler is not None:
            signal.signal(signal.SIGTERM, prev_handler)
