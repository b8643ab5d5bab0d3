"""The launcher; counterpart of ``paddle_tpu/distributed/launch/main.py``
(ref: ``python/paddle/distributed/launch/``).

One process per card, as upstream Paddle on GPUs (the JAX package starts
one process per host).  :func:`launch` builds the kernels once, then
starts one process per entry of ``devices`` with the environment
contract of ``env.py`` (``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_MASTER``, ``PADDLE_RANK_IN_NODE``, ``FLAGS_selected_gpus``,
endpoints) and each rank's output in ``log_dir/workerlog.<rank>``.  The
launcher serves each group's rendezvous store itself, on a port the
kernel picks, and the ranks connect to it.  When any rank exits non-zero, it kills
the others and restarts the group, up to ``max_restart`` times, then
gives up with the failing rank's exit code.  With ``elastic_timeout``
it also watches the ranks' progress heartbeats (``fleet.elastic``:
``worker_heartbeat(mode="progress")``, which ``resilience.
ResilientTrainLoop`` pings each step): a rank whose heartbeat stays
stale for ``elastic_timeout`` seconds (two polls running) stops and
restarts the whole group the same way, and the script resumes from its
newest committed checkpoint.  A ``FLAGS_fault_schedule`` in the
environment gets a job-scoped fired-state file, so each scheduled fault
fires once per job, not once per restart.  ``device="cpu"`` starts
ranks for ``init_parallel_env(device="cpu")`` (gloo) without building
kernels; without it, a machine with no card raises.

Usage: ``python -m paddle_tpu_torch.distributed.launch [--nproc_per_node
N] [--devices 0,1,2,3] [--log_dir DIR] [--max_restart K]
[--elastic_timeout S] [--device cpu] script.py args...``.
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
from typing import List, Optional

__all__ = ["launch", "main"]

# seconds a rank gets to exit after SIGTERM before SIGKILL
KILL_GRACE_S = 5.0
_POLL_S = 0.1


def _rank_env(rank: int, n: int, device: str, master: str) -> dict:
    env = dict(os.environ)
    host, _, port = master.rpartition(":")
    eps = [f"{host}:{int(port) + 1 + i}" for i in range(n)]
    env.update({
        "PADDLE_TRAINER_ID": str(rank), "PADDLE_TRAINERS_NUM": str(n),
        "PADDLE_MASTER": master, "MASTER_ADDR": host, "MASTER_PORT": port,
        "PADDLE_RANK_IN_NODE": str(rank), "FLAGS_selected_gpus": device,
        "PADDLE_TRAINER_ENDPOINTS": ",".join(eps),
        "PADDLE_CURRENT_ENDPOINT": eps[rank]})
    # the workers import the package from this checkout, installed or not
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    pp = env.get("PYTHONPATH", "")
    if root not in pp.split(os.pathsep):
        env["PYTHONPATH"] = root + (os.pathsep + pp if pp else "")
    return env


def _stop(procs) -> None:
    """SIGTERM every live rank, then SIGKILL those still alive after
    ``KILL_GRACE_S``."""
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    deadline = time.monotonic() + KILL_GRACE_S
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.01))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _tail(path: str, lines: int = 20) -> str:
    try:
        with open(path, errors="replace") as f:
            return "".join(f.readlines()[-lines:])
    except OSError:
        return ""


def _run_group(cmd, devices, log_dir, attempt, fault_state,
               manager=None) -> int:
    """Start one process per device; return 0 when every rank exits 0,
    else the first failing rank's exit code (the others killed), or 1
    when ``manager`` (an ``ElasticManager`` over every rank) sees a
    stale heartbeat."""
    from ..fleet.elastic import ElasticStatus
    from ..parallel import STORE_SERVED_ENV, serve_store
    n = len(devices)
    if manager is not None:
        manager.reset()
    store = serve_store(n)           # this group's rendezvous, served here
    master = f"127.0.0.1:{store.port}"
    procs, logs = [], []
    try:
        for r, dev in enumerate(devices):
            env = _rank_env(r, n, dev, master)
            env[STORE_SERVED_ENV] = "1"
            if fault_state is not None:
                env.setdefault("PADDLE_FAULT_STATE_FILE", fault_state)
            if manager is not None:
                env["PADDLE_ELASTIC_REGISTRY"] = manager.registry
            path = os.path.join(log_dir, f"workerlog.{r}")
            log = open(path, "a")
            logs.append(log)
            log.write(f"=== attempt {attempt}: rank {r} of {n}, device "
                      f"{dev}, master {master}\n")
            log.flush()
            procs.append(subprocess.Popen(cmd, env=env, stdout=log,
                                          stderr=subprocess.STDOUT))
        while True:
            codes = [p.poll() for p in procs]
            bad = [(r, c) for r, c in enumerate(codes)
                   if c is not None and c != 0]
            if bad:
                r, code = bad[0]
                print(f"launch: rank {r} exited with {code} (attempt "
                      f"{attempt}); stopping the group.  Its log "
                      f"ends:\n{_tail(os.path.join(log_dir, f'workerlog.{r}'))}",
                      file=sys.stderr, flush=True)
                return code if code > 0 else 128 - code
            if all(c == 0 for c in codes):
                return 0
            if manager is not None and manager.enabled() and \
                    manager.watch() == ElasticStatus.RESTART:
                print(f"launch: a rank's progress heartbeat is older than "
                      f"{manager.heartbeat_timeout} s (attempt {attempt}); "
                      "stopping the group", file=sys.stderr, flush=True)
                return 1
            time.sleep(_POLL_S)
    finally:
        _stop(procs)
        for log in logs:
            log.close()


def launch(script: str, script_args: Optional[List[str]] = None,
           nnodes: int = 1, rank: Optional[int] = None,
           master: Optional[str] = None, devices: Optional[str] = None,
           log_dir: str = "log", max_restart: int = 3,
           run_mode: str = "collective",
           elastic_timeout: Optional[float] = None, *,
           device: Optional[str] = None) -> int:
    """Run ``script`` on one process per entry of ``devices`` (comma-
    separated card ids; default every visible card), restarting the group
    up to ``max_restart`` times; returns 0 or the failing exit code.
    ``PADDLE_ELASTIC_RESTART_BACKOFF`` (seconds, default 10) times the
    restart count is the pause before a restart, at most 60 s.
    ``elastic_timeout`` (seconds) turns on the heartbeat supervisor of
    ``fleet.elastic`` over every rank (module docstring).  More than one
    node, a ``master`` of another host and ``run_mode`` other than
    ``"collective"`` raise ``NotImplementedError``."""
    if int(nnodes) != 1 or rank not in (None, 0):
        raise NotImplementedError("more than one node waits for a later "
                                  "slice")
    if master is not None:
        raise NotImplementedError("master: the launcher serves the store on "
                                  "this host")
    if run_mode != "collective":
        raise NotImplementedError(f"run_mode {run_mode!r}")
    if device not in (None, "gpu", "cpu"):
        raise ValueError(f"device {device!r}: 'gpu' or 'cpu'")
    if device == "cpu":
        devs = devices.split(",") if devices else ["0"]
    else:
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' for gloo ranks")
        devs = devices.split(",") if devices else \
            [str(i) for i in range(torch.cuda.device_count())]
        from ...ops import _build
        _build.build_all()     # once, before the ranks would each build
    os.makedirs(log_dir, exist_ok=True)
    cmd = [sys.executable, "-u", script] + list(script_args or [])
    # a scheduled fault fires once per job, not once per restart
    fault_state = os.path.join(os.path.abspath(log_dir), "fault_state.txt") \
        if os.environ.get("FLAGS_fault_schedule") else None
    backoff = float(os.environ.get("PADDLE_ELASTIC_RESTART_BACKOFF", 10))
    manager = None
    if elastic_timeout is not None:
        from ..fleet.elastic import ElasticManager
        # a registry of this job's own unless the caller names one
        job_id = None if os.environ.get("PADDLE_ELASTIC_REGISTRY") else \
            f"launch_{os.getpid()}_{time.monotonic_ns()}"
        manager = ElasticManager(ranks=range(len(devs)), job_id=job_id)
        manager.heartbeat_timeout = float(elastic_timeout)   # over the env
    restarts = 0
    while True:
        code = _run_group(cmd, devs, log_dir, restarts, fault_state,
                          manager)
        if code == 0:
            return 0
        restarts += 1
        if restarts > max_restart:
            print(f"launch: giving up after {max_restart} restarts",
                  file=sys.stderr, flush=True)
            return code
        time.sleep(min(backoff * restarts, 60.0))


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.distributed.launch",
        description="start one process per card and supervise them")
    p.add_argument("--nnodes", default="1")
    p.add_argument("--nproc_per_node", type=int, default=None,
                   help="ranks on this node (default: one per device)")
    p.add_argument("--rank", default=None)
    p.add_argument("--master", default=None)
    p.add_argument("--devices", "--gpus", dest="devices", default=None)
    p.add_argument("--log_dir", default="log")
    p.add_argument("--max_restart", type=int, default=3)
    p.add_argument("--run_mode", default="collective")
    p.add_argument("--elastic_timeout", type=float, default=None,
                   help="seconds a rank's progress heartbeat may go "
                        "stale before the group restarts")
    p.add_argument("--device", choices=("gpu", "cpu"), default=None,
                   help="cpu: gloo ranks on the CPU, no kernel build")
    p.add_argument("script")
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    # a SIGTERM unwinds like an exception, so the ranks are stopped too
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(128 + signal.SIGTERM))
    devices = args.devices
    if args.nproc_per_node is not None:
        if devices and len(devices.split(",")) != args.nproc_per_node:
            p.error("--nproc_per_node differs from the --devices count")
        devices = devices or ",".join(
            str(i) for i in range(args.nproc_per_node))
    return launch(args.script, args.script_args, nnodes=int(args.nnodes),
                  rank=None if args.rank is None else int(args.rank),
                  master=args.master, devices=devices,
                  log_dir=args.log_dir, max_restart=args.max_restart,
                  run_mode=args.run_mode,
                  elastic_timeout=args.elastic_timeout, device=args.device)


if __name__ == "__main__":
    sys.exit(main())
