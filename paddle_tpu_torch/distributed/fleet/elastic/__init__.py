"""The elastic manager; a copy of
``paddle_tpu/distributed/fleet/elastic/__init__.py`` (stdlib only; ref:
``python/paddle/distributed/fleet/elastic/manager.py`` — etcd node
registry, watch join/leave, fault-tolerance levels, checkpoint-restart
hooks into launch).

The reference's etcd registry becomes a filesystem heartbeat registry
(``PADDLE_ELASTIC_REGISTRY``, else a job directory under the temporary
directory).  A supervisor detects both failure modes of its ranks:

* crash — the process exits nonzero (e.g. SIGKILL on host loss);
* stall — the worker's heartbeat goes stale.  Heartbeats come in two
  modes: ``thread`` (a daemon timer — process liveness) and
  ``progress`` (the timestamp only advances on ``ping()`` calls from
  the training loop — catches the wedged-device case where the process
  is alive but no step completes, which a timer thread cannot see).

On either, the supervisor (``distributed.launch`` with
``elastic_timeout``, or ``resilience.run_resilient``) stops the ranks
and starts them again; the script resumes from its newest committed
checkpoint (``distributed.checkpoint`` with ``unique_id`` versions).
"""
from __future__ import annotations

import json
import os
import signal
import tempfile
import threading
import time
from typing import Dict, List, Optional, Sequence

__all__ = ["ElasticManager", "ElasticStatus", "LauncherInterface",
           "worker_heartbeat"]


class ElasticStatus:
    COMPLETED = "completed"
    ERROR = "error"
    HOLD = "hold"
    RESTART = "restart"
    EXIT = "exit"


def _registry_dir(job_id: Optional[str] = None) -> str:
    d = os.environ.get("PADDLE_ELASTIC_REGISTRY")
    if not d:
        jid = job_id or os.environ.get("PADDLE_ELASTIC_JOB_ID", "default")
        d = os.path.join(tempfile.gettempdir(), f"paddle_elastic_{jid}")
    os.makedirs(d, exist_ok=True)
    return d


class _HeartbeatThread(threading.Thread):
    """Writes ``{pid, ts}`` atomically (tmp + os.replace — a supervisor
    polling mid-write must never see a torn file)."""

    def __init__(self, path: str, interval: float, progress: bool):
        super().__init__(daemon=True)
        self.path = path
        self.interval = interval
        self.progress = progress
        self._last_ping = time.time()
        self._pinged = False
        self._stop = threading.Event()

    def ping(self):
        """Mark training progress (each completed step)."""
        self._pinged = True
        self._last_ping = time.time()

    def run(self):
        while not self._stop.is_set():
            # progress mode reports wall time until the FIRST ping: the
            # first step's XLA compile / checkpoint load can take far
            # longer than any sane stall timeout, and killing a worker
            # mid-compile would loop forever
            live = (not self.progress) or (not self._pinged)
            ts = time.time() if live else self._last_ping
            tmp = self.path + f".tmp{os.getpid()}"
            try:
                with open(tmp, "w") as f:
                    json.dump({"pid": os.getpid(), "ts": ts}, f)
                os.replace(tmp, self.path)
            except OSError:
                pass
            self._stop.wait(self.interval)

    def stop(self):
        self._stop.set()


def worker_heartbeat(rank: Optional[int] = None, interval: float = 1.0,
                     job_id: Optional[str] = None,
                     mode: str = "thread") -> _HeartbeatThread:
    """Start this worker's heartbeat (ref: the manager registering the
    node in etcd).  mode='progress' only advances the timestamp on
    ``ping()`` — call it once per training step."""
    if mode not in ("thread", "progress"):
        raise ValueError(f"heartbeat mode must be thread/progress, "
                         f"got {mode!r}")
    r = rank if rank is not None else int(
        os.environ.get("PADDLE_TRAINER_ID", "0"))
    path = os.path.join(_registry_dir(job_id), f"worker_{r}.hb")
    t = _HeartbeatThread(path, interval, progress=(mode == "progress"))
    t.start()
    return t


class ElasticManager:
    """Liveness watcher over a set of worker ranks (ref: manager.py
    ElasticManager).  A launcher passes its LOCAL rank(s); a global
    coordinator may pass all of them."""

    def __init__(self, args=None, etcd_client=None,
                 job_id: Optional[str] = None, np: Optional[int] = None,
                 ranks: Optional[Sequence[int]] = None,
                 heartbeat_timeout: float = 10.0,
                 stale_polls_to_restart: int = 2):
        self.args = args
        # both spellings are honored — the reference's env var is the
        # typo'd PADDLE_ELASTIC_FAULT_TOLERANC_LEVEL; precedence: the
        # CORRECT spelling (…TOLERANCE_LEVEL) wins when both are set,
        # the reference spelling is the fallback, default level 1
        _lvl = os.environ.get("PADDLE_ELASTIC_FAULT_TOLERANCE_LEVEL")
        if _lvl is None:
            _lvl = os.environ.get(
                "PADDLE_ELASTIC_FAULT_TOLERANC_LEVEL", "1")
        self.elastic_level = int(_lvl)
        self.np = int(np if np is not None else
                      os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        self.ranks = list(ranks) if ranks is not None \
            else list(range(self.np))
        self.job_id = job_id
        self.registry = _registry_dir(job_id)
        self.heartbeat_timeout = float(os.environ.get(
            "PADDLE_ELASTIC_TIMEOUT", heartbeat_timeout))
        # one stale observation may be a scheduling hiccup; require N
        # consecutive before declaring a restart
        self.stale_polls_to_restart = int(stale_polls_to_restart)
        self._stale_streak = 0
        self._stopped = False
        self.launcher: Optional["LauncherInterface"] = None

    def enabled(self) -> bool:
        return self.elastic_level > 0

    # -- worker registry -------------------------------------------------
    def _hb_path(self, rank: int) -> str:
        return os.path.join(self.registry, f"worker_{rank}.hb")

    def _done_path(self, rank: int) -> str:
        return os.path.join(self.registry, f"worker_{rank}.done")

    def mark_completed(self, rank: Optional[int] = None):
        r = rank if rank is not None else int(
            os.environ.get("PADDLE_TRAINER_ID", "0"))
        with open(self._done_path(r), "w") as f:
            f.write(str(time.time()))

    def reset(self):
        """Clear THIS manager's ranks' state before a (re)launch (peers'
        files in a shared registry are never touched).  Also sweeps
        orphaned ``worker_<r>.hb.tmp<pid>`` files — a worker SIGKILLed
        between the tmp write and the atomic rename leaves one behind
        per crash, and a long-lived registry would accumulate them."""
        import glob
        self._stale_streak = 0
        for r in self.ranks:
            paths = [self._hb_path(r), self._done_path(r)]
            paths += glob.glob(self._hb_path(r) + ".tmp*")
            for path in paths:
                try:
                    os.remove(path)
                except OSError:
                    pass

    # -- liveness --------------------------------------------------------
    def worker_alive(self, rank: int) -> bool:
        """Heartbeat fresh (a registered-but-stale worker counts as dead
        even if its pid still exists — the stalled-process case)."""
        try:
            with open(self._hb_path(rank)) as f:
                hb = json.load(f)
        except (OSError, ValueError):
            return False
        return (time.time() - float(hb.get("ts", 0))) \
            < self.heartbeat_timeout

    def watch(self) -> str:
        """One poll of the watched ranks' health (ref: manager.watch)."""
        if self._stopped:
            return ElasticStatus.EXIT
        if all(os.path.exists(self._done_path(r)) for r in self.ranks):
            return ElasticStatus.COMPLETED
        registered = [r for r in self.ranks
                      if os.path.exists(self._hb_path(r))]
        if not registered:
            self._stale_streak = 0
            return ElasticStatus.HOLD       # nothing registered yet
        stale = [r for r in registered if not self.worker_alive(r)
                 and not os.path.exists(self._done_path(r))]
        if stale:
            self._stale_streak += 1
            if self._stale_streak >= self.stale_polls_to_restart:
                return ElasticStatus.RESTART
            return ElasticStatus.HOLD
        self._stale_streak = 0
        return ElasticStatus.HOLD

    def pre_hook(self):
        return None

    def signal_handler(self, sigint, frame):
        self._stopped = True
        if self.launcher is not None:
            self.launcher.stop()

    def exit(self, completed: bool = True):
        self._stopped = True


class LauncherInterface:
    """Process supervisor used by the elastic launch loop (ref: elastic/
    manager.py LauncherInterface)."""

    def __init__(self, args=None):
        self.args = args
        self.procs: List = []

    def launch(self, cmd: List[str], env: Dict[str, str], log_path: str):
        import subprocess
        logf = open(log_path, "ab")
        proc = subprocess.Popen(cmd, env=env, stdout=logf,
                                stderr=subprocess.STDOUT)
        proc._logf = logf
        self.procs.append(proc)
        return proc

    def stop(self):
        for p in self.procs:
            if p.poll() is None:
                try:
                    p.send_signal(signal.SIGTERM)
                except OSError:
                    pass
        deadline = time.time() + 5.0
        for p in self.procs:
            while p.poll() is None and time.time() < deadline:
                time.sleep(0.1)
            if p.poll() is None:
                try:
                    p.kill()
                except OSError:
                    pass
            logf = getattr(p, "_logf", None)
            if logf is not None:
                logf.close()
        self.procs = []

    def watch(self) -> Optional[str]:
        """Exit-code view of the processes: COMPLETED when all exited 0,
        ERROR if any exited nonzero, None while running."""
        codes = [p.poll() for p in self.procs]
        if any(c is not None and c != 0 for c in codes):
            return ElasticStatus.ERROR
        if codes and all(c == 0 for c in codes):
            return ElasticStatus.COMPLETED
        return None


def __getattr__(name):
    if name == "manager":   # ref import path: fleet.elastic.manager
        import importlib
        mod = importlib.import_module(".manager", __name__)
        globals()["manager"] = mod
        return mod
    raise AttributeError(name)
