"""Replica supervisor — N serving-engine processes under one parent; a
copy of ``paddle_tpu/serving/fleet/replica.py``.

Each replica is a subprocess running a :class:`~paddle_tpu_torch.serving.
ServingEngine` behind an :class:`~paddle_tpu_torch.inference.serving.
InferenceServer` (the ``--worker`` entry of ``python -m
paddle_tpu_torch.serving.fleet``).  The supervisor owns their lifecycle:

* **launch + readiness** — a worker writes its URL to a per-replica
  port file (atomic rename) once its HTTP socket is bound; the
  supervisor polls the file, so port 0 (OS-assigned) just works and a
  relaunched replica may come back on a different port.
* **crash supervision** — the same restart-cap / deterministic
  exponential-backoff / give-up machinery as ``resilience.driver``
  (:func:`~paddle_tpu_torch.resilience.driver.restart_backoff` is
  literally shared), emitting ``replica_restart`` events the chaos tests
  and the fleet dashboard key on.
* **drain-aware rolling restarts** — per replica: mark it draining
  (the router stops placing new work on it), SIGTERM (the worker stops
  accepting, drains in-flight streams via the existing
  ``stop(drain_timeout)``, exits 0), wait out the grace window
  (SIGKILL past it), relaunch, wait ready.  In-flight streams finish;
  new work flows to the survivors — a config rollout never truncates
  a response.

The supervisor does NOT poll replica health itself — liveness here is
process-level (``proc.poll()``).  HTTP-level health (queue depth,
occupancy, reachability from ``GET /metrics``) is the router's job:
routing decisions need those numbers fresh at placement time, so the
poller lives next to the placement policy in ``router.py``.
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from ...observability import events as _events
from ...observability import metrics as _metrics
from ...observability.lockwatch import make_lock
from ...resilience.driver import restart_backoff

__all__ = ["ReplicaHandle", "ReplicaSupervisor"]

_RESTARTS = _metrics.counter(
    "paddle_fleet_replica_restarts_total",
    "replica relaunches by the fleet supervisor",
    labels=("replica", "reason"))


class ReplicaHandle:
    """One supervised replica: process + endpoint + routing state.

    ``healthy`` / ``queue_depth`` / ``occupancy`` are maintained by
    the router's poller (GIL-atomic scalar writes); ``draining`` is
    set by the supervisor during rolling restarts and honored by the
    router's placement policy.
    """

    def __init__(self, replica_id: str, port_file: str):
        self.id = str(replica_id)
        self.port_file = port_file
        self.proc: Optional[subprocess.Popen] = None
        self.url: Optional[str] = None
        self.restarts = 0
        self.gone = False          # restart cap exhausted
        self.draining = False
        self.healthy = False
        self.queue_depth = 0.0
        self.occupancy = 0.0
        # engine health state machine (ok/degraded/quarantining/
        # failed), parsed by the router's poller from the replica's
        # paddle_serving_engine_health gauge; "failed" makes the
        # replica unroutable even while its process is alive
        self.health_state = "ok"

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def routable(self) -> bool:
        # proc is None for externally-managed (static) endpoints —
        # HTTP health is the only liveness signal there
        proc_ok = self.proc is None or self.alive
        return (self.url is not None and proc_ok
                and not self.draining and not self.gone
                and self.healthy and self.health_state != "failed")

    def __repr__(self) -> str:
        return (f"ReplicaHandle(id={self.id!r}, url={self.url!r}, "
                f"alive={self.alive}, draining={self.draining}, "
                f"restarts={self.restarts})")


def _default_argv_builder(worker_args: Sequence[str]
                          ) -> Callable[[str, str], List[str]]:
    def build(replica_id: str, port_file: str) -> List[str]:
        return [sys.executable, "-u", "-m",
                "paddle_tpu_torch.serving.fleet",
                "--worker", "--replica-id", replica_id,
                "--port-file", port_file, *worker_args]
    return build


class ReplicaSupervisor:
    """Launch and supervise ``n_replicas`` engine processes.

    ``argv_builder(replica_id, port_file) -> argv`` overrides the
    worker command (tests supervise lightweight stub servers with it);
    the default runs the real fleet worker with ``worker_args``
    appended.  ``env`` overlays ``os.environ`` for the children —
    per-replica values may use ``{replica}`` formatting (e.g.
    observability dirs that must not interleave JSONL writers).
    """

    def __init__(self, n_replicas: int, *,
                 worker_args: Sequence[str] = (),
                 argv_builder: Optional[Callable[[str, str],
                                                 List[str]]] = None,
                 env: Optional[Dict[str, str]] = None,
                 max_restarts: int = 5,
                 restart_backoff_s: float = 0.5,
                 max_backoff_s: float = 30.0,
                 poll_interval: float = 0.25,
                 ready_timeout: float = 180.0,
                 preempt_grace_s: float = 15.0):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got "
                             f"{n_replicas}")
        self._argv = argv_builder or _default_argv_builder(
            tuple(worker_args))
        self._env = dict(env or {})
        self.max_restarts = int(max_restarts)
        self.restart_backoff_s = float(restart_backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.poll_interval = float(poll_interval)
        self.ready_timeout = float(ready_timeout)
        self.preempt_grace_s = float(preempt_grace_s)
        self._dir = tempfile.mkdtemp(prefix="paddle_fleet_")
        self.replicas: List[ReplicaHandle] = [
            ReplicaHandle(str(i),
                          os.path.join(self._dir, f"replica-{i}.port"))
            for i in range(int(n_replicas))]
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = make_lock("fleet.replica._lock")
        # replicas due for relaunch: id -> monotonic deadline (backoff
        # staged without blocking the poll thread on one replica)
        self._relaunch_at: Dict[str, float] = {}

    # -- process control --------------------------------------------------
    def _child_env(self, handle: ReplicaHandle) -> Dict[str, str]:
        env = dict(os.environ)
        for k, v in self._env.items():
            env[k] = v.format(replica=handle.id) if "{replica}" in v \
                else v
        return env

    def _launch(self, handle: ReplicaHandle) -> None:
        try:
            os.unlink(handle.port_file)
        except OSError:
            pass
        handle.url = None
        handle.healthy = False
        handle.health_state = "ok"   # fresh process, fresh engine
        argv = self._argv(handle.id, handle.port_file)
        handle.proc = subprocess.Popen(argv,
                                       env=self._child_env(handle),
                                       start_new_session=True)

    def _read_port_file(self, handle: ReplicaHandle) -> Optional[str]:
        try:
            with open(handle.port_file, "r", encoding="utf-8") as fh:
                url = fh.read().strip()
        except OSError:
            return None
        return url or None

    def wait_ready(self, timeout: Optional[float] = None) -> None:
        """Block until every live replica has published its URL."""
        deadline = time.monotonic() + (timeout if timeout is not None
                                       else self.ready_timeout)
        pending = [h for h in self.replicas if not h.gone]
        while pending:
            still = []
            for h in pending:
                url = self._read_port_file(h)
                if url is not None:
                    h.url = url
                    h.healthy = True
                    continue
                if not h.alive:
                    code = h.proc.returncode if h.proc else -1
                    raise RuntimeError(
                        f"replica {h.id} exited (rc={code}) before "
                        "publishing its port file")
                still.append(h)
            pending = still
            if pending and time.monotonic() > deadline:
                ids = ",".join(h.id for h in pending)
                raise TimeoutError(
                    f"replica(s) {ids} not ready within "
                    f"{self.ready_timeout}s")
            if pending:
                time.sleep(0.05)

    def start(self) -> "ReplicaSupervisor":
        for h in self.replicas:
            self._launch(h)
        self.wait_ready()
        self._thread = threading.Thread(target=self._supervise_loop,
                                        name="fleet-supervisor",
                                        daemon=True)
        self._thread.start()
        return self

    # -- crash supervision ------------------------------------------------
    def _supervise_loop(self) -> None:
        while not self._stop.wait(self.poll_interval):
            now = time.monotonic()
            for h in self.replicas:
                with self._lock:
                    if h.gone or h.draining:
                        continue        # rolling restart owns it
                    if h.alive:
                        url = self._read_port_file(h)
                        if url is not None and h.url != url:
                            # relaunched replica published its (new)
                            # endpoint — routable again
                            h.url = url
                            h.healthy = True
                        continue
                    if h.id not in self._relaunch_at:
                        # freshly observed death: schedule the relaunch
                        code = h.proc.returncode if h.proc else -1
                        h.restarts += 1
                        h.healthy = False
                        h.url = None
                        if h.restarts > self.max_restarts:
                            h.gone = True
                            _RESTARTS.labels(replica=h.id,
                                             reason="gave-up").inc()
                            _events.emit("replica_restart",
                                         replica=h.id,
                                         reason="gave-up",
                                         restarts=h.restarts,
                                         code=int(code or 1))
                            continue
                        delay = restart_backoff(h.restarts,
                                                self.restart_backoff_s,
                                                self.max_backoff_s)
                        self._relaunch_at[h.id] = now + delay
                        _RESTARTS.labels(replica=h.id,
                                         reason="crash").inc()
                        _events.emit("replica_restart", replica=h.id,
                                     reason="crash",
                                     restarts=h.restarts,
                                     code=int(code or 1))
                    elif now >= self._relaunch_at[h.id]:
                        del self._relaunch_at[h.id]
                        self._launch(h)

    # -- rolling restart --------------------------------------------------
    def _terminate(self, handle: ReplicaHandle,
                   grace_s: Optional[float] = None) -> int:
        """SIGTERM, wait out the grace window, SIGKILL past it.
        Returns the exit code."""
        if handle.proc is None:
            return 0
        grace = self.preempt_grace_s if grace_s is None else grace_s
        if handle.proc.poll() is None:
            try:
                handle.proc.send_signal(signal.SIGTERM)
            except OSError:
                pass
            try:
                handle.proc.wait(timeout=grace)
            except subprocess.TimeoutExpired:
                handle.proc.kill()
                handle.proc.wait(timeout=10)
        return int(handle.proc.returncode or 0)

    def rolling_restart(self,
                        ready_timeout: Optional[float] = None) -> None:
        """Restart every replica one at a time, drain-aware: the
        router sees ``draining`` and routes around it, the worker's
        SIGTERM handler finishes in-flight streams before exiting."""
        for h in self.replicas:
            if h.gone:
                continue
            with self._lock:
                h.draining = True
                h.healthy = False
            code = self._terminate(h)
            with self._lock:
                h.restarts += 1
                h.url = None
                self._relaunch_at.pop(h.id, None)
                self._launch(h)
            _RESTARTS.labels(replica=h.id, reason="rolling").inc()
            _events.emit("replica_restart", replica=h.id,
                         reason="rolling", restarts=h.restarts,
                         code=code)
            deadline = time.monotonic() + (
                ready_timeout if ready_timeout is not None
                else self.ready_timeout)
            while True:
                url = self._read_port_file(h)
                if url is not None:
                    h.url = url
                    break
                if not h.alive:
                    raise RuntimeError(
                        f"replica {h.id} died during rolling restart")
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"replica {h.id} not ready after rolling "
                        "restart")
                time.sleep(0.05)
            with self._lock:
                h.healthy = True
                h.draining = False

    def kill(self, replica_id: str) -> None:
        """SIGKILL one replica (chaos entry point — the supervisor's
        poll observes the death and relaunches with backoff)."""
        for h in self.replicas:
            if h.id == str(replica_id) and h.proc is not None:
                h.proc.kill()
                return
        raise KeyError(f"no replica {replica_id!r}")

    def restart_replica(self, replica_id: str,
                        reason: str = "health") -> bool:
        """Deliberately restart one replica (the router calls this
        when an engine reports ``failed`` health): mark it unroutable,
        SIGTERM it off-thread (grace window, then SIGKILL), and let
        the supervise loop relaunch it through the normal
        crash-with-backoff path.  Returns False when the replica is
        unknown or already gone (restart cap exhausted)."""
        for h in self.replicas:
            if h.id != str(replica_id):
                continue
            with self._lock:
                if h.gone or h.proc is None:
                    return False
                h.healthy = False
            _RESTARTS.labels(replica=h.id, reason=reason).inc()
            _events.emit("replica_restart", replica=h.id,
                         reason=reason, restarts=h.restarts,
                         code=0)
            # terminate OFF-thread: the grace window can be seconds
            # and the caller is the router's poll loop — blocking it
            # would stall health updates for every other replica
            threading.Thread(target=self._terminate, args=(h,),
                             name=f"fleet-restart-{h.id}",
                             daemon=True).start()
            return True
        raise KeyError(f"no replica {replica_id!r}")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        for h in self.replicas:
            self._terminate(h)

    def __enter__(self) -> "ReplicaSupervisor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
