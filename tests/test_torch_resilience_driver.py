"""The port's ``fleet.elastic``, ``distributed.launch(elastic_timeout=)``
and resilient training driver (``resilience.ResilientTrainLoop`` /
``run_resilient``), on ``tests/test_elastic.py``'s and
``tests/test_resilience.py``'s scenarios:

* the manager's states and a progress heartbeat that goes stale;
* the launcher killing a hung worker (its progress heartbeat stale past
  ``elastic_timeout=1.5``) and restarting it, and restarting a SIGKILLed
  worker that resumes from its own state;
* ``ResilientTrainLoop``'s preemption: SIGTERM, a final committed
  checkpoint, a clean exit, and the resume after it;
* a ``run_resilient`` chaos run on a tiny model (a ``Linear(4, 4)``
  under the port's AdamW, checkpointed every step through
  ``distributed.checkpoint``): ``step@2=stall:120`` (the supervisor's
  heartbeat watch kills it) and ``ckpt_write@3=crash`` (SIGKILL between
  the data and the commit).  It reaches its target with every loss and
  the final parameters of the uninterrupted supervised run, bit for
  bit; each relaunch resumes from a committed version, never the torn
  one.

The reference's chaos tests are marked slow; these use timeouts of a
second or two and stay in tier-1.
"""
import json
import os
import signal
import sys
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.distributed.fleet.elastic import (ElasticManager,
                                                        ElasticStatus,
                                                        worker_heartbeat)
from paddle_tpu_torch.distributed.launch import launch
from paddle_tpu_torch.resilience import (ResilientTrainLoop, RunReport,
                                         run_resilient)
from paddle_tpu_torch.resilience import faults as rf

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_injector(monkeypatch):
    monkeypatch.delenv(rf.STATE_FILE_ENV, raising=False)
    monkeypatch.delenv("FLAGS_fault_schedule", raising=False)
    rf.install_schedule(None)
    yield
    rf.install_schedule(None)


def test_manager_watch_states(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_ELASTIC_REGISTRY", str(tmp_path))
    monkeypatch.setenv("PADDLE_ELASTIC_TIMEOUT", "1.0")
    m = ElasticManager(np=1)
    assert m.enabled()
    assert m.watch() == ElasticStatus.HOLD      # nothing registered yet
    hb = worker_heartbeat(rank=0, interval=0.2)
    time.sleep(0.4)
    assert m.watch() == ElasticStatus.HOLD      # alive
    assert m.worker_alive(0)
    hb.stop()
    time.sleep(1.3)
    assert not m.worker_alive(0)
    # one stale poll is a grace HOLD; the second confirms RESTART
    assert m.watch() == ElasticStatus.HOLD
    assert m.watch() == ElasticStatus.RESTART
    m.mark_completed(0)
    assert m.watch() == ElasticStatus.COMPLETED


def test_progress_heartbeat_goes_stale_without_pings(tmp_path,
                                                     monkeypatch):
    monkeypatch.setenv("PADDLE_ELASTIC_REGISTRY", str(tmp_path))
    m = ElasticManager(np=1, heartbeat_timeout=1.0,
                       stale_polls_to_restart=1)
    hb = worker_heartbeat(rank=0, interval=0.1, mode="progress")
    hb.ping()
    time.sleep(0.3)
    assert m.worker_alive(0)
    time.sleep(1.2)                 # the thread writes, ts stops advancing
    assert not m.worker_alive(0)
    assert m.watch() == ElasticStatus.RESTART
    hb.ping()
    time.sleep(0.3)
    assert m.worker_alive(0)
    hb.stop()


_CRASH_WORKER = r"""
import json, os, signal
STEPS = 6
state_file = os.environ["TRAIN_STATE"]
start = 0
if os.path.exists(state_file):
    with open(state_file) as f:
        start = json.load(f)["step"] + 1
with open(os.environ["RUNS_FILE"], "a") as f:
    f.write(f"run_start {start}\n")
for step in range(start, STEPS):
    with open(state_file, "w") as f:
        json.dump({"step": step}, f)
    if step == 2 and not os.path.exists(state_file + ".crashed"):
        open(state_file + ".crashed", "w").close()
        os.kill(os.getpid(), signal.SIGKILL)   # simulated host loss
with open(os.environ["RUNS_FILE"], "a") as f:
    f.write("done\n")
"""


def test_launch_restarts_after_sigkill_and_resumes(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_ELASTIC_RESTART_BACKOFF", "0")
    script = tmp_path / "worker.py"
    script.write_text(_CRASH_WORKER)
    runs = tmp_path / "runs.log"
    monkeypatch.setenv("TRAIN_STATE", str(tmp_path / "state.json"))
    monkeypatch.setenv("RUNS_FILE", str(runs))
    code = launch(str(script), log_dir=str(tmp_path / "logs"),
                  max_restart=2, device="cpu")
    assert code == 0
    lines = runs.read_text().splitlines()
    assert lines[:2] == ["run_start 0", "run_start 3"], lines
    assert lines[-1] == "done"


_HANG_WORKER = r"""
import json, os, time
import paddle_tpu_torch.distributed.fleet.elastic as elastic
state_file = os.environ["TRAIN_STATE"]
first = not os.path.exists(state_file)
with open(os.environ["RUNS_FILE"], "a") as f:
    f.write("hang_run\n")
hb = elastic.worker_heartbeat(interval=0.2, mode="progress")
hb.ping()
if first:
    with open(state_file, "w") as f:
        json.dump({"step": 0}, f)
    time.sleep(600)       # the step wedges; no more pings
elastic.ElasticManager(np=1).mark_completed()
"""


def test_launch_kills_a_hung_worker_and_restarts_it(tmp_path,
                                                    monkeypatch):
    monkeypatch.setenv("PADDLE_ELASTIC_REGISTRY", str(tmp_path / "reg"))
    monkeypatch.setenv("PADDLE_ELASTIC_RESTART_BACKOFF", "0")
    monkeypatch.setenv("PYTHONPATH", _REPO)
    script = tmp_path / "worker.py"
    script.write_text(_HANG_WORKER)
    runs = tmp_path / "runs.log"
    monkeypatch.setenv("TRAIN_STATE", str(tmp_path / "state.json"))
    monkeypatch.setenv("RUNS_FILE", str(runs))
    t0 = time.monotonic()
    code = launch(str(script), log_dir=str(tmp_path / "logs"),
                  max_restart=2, elastic_timeout=1.5, device="cpu")
    assert code == 0
    assert time.monotonic() - t0 < 60        # well before the 600 s sleep
    assert runs.read_text().splitlines().count("hang_run") == 2


def test_preemption_final_checkpoint_then_resume(tmp_path):
    path = str(tmp_path / "ck")
    m = torch.nn.Linear(3, 3)
    loop = ResilientTrainLoop(path, m.state_dict(), save_every=100,
                              keep_last_k=None, heartbeat=False)
    loop.end_step(0)                                # no periodic save yet
    assert ckpt.latest_committed(path) is None
    with torch.no_grad():
        m.weight.fill_(5.0)
    os.kill(os.getpid(), signal.SIGTERM)            # the handler sets it
    with pytest.raises(SystemExit) as e:
        loop.end_step(1)
    assert e.value.code == 0                        # clean: no relaunch
    got = ckpt.latest_committed(path)
    assert got is not None and got[1]["meta"]["step"] == 1

    m2 = torch.nn.Linear(3, 3)
    loop2 = ResilientTrainLoop(path, m2.state_dict(), heartbeat=False)
    assert loop2.restore() == 2                     # resume AFTER step 1
    np.testing.assert_allclose(m2.weight.detach().numpy(), 5.0)
    loop2._teardown()


# a tiny model trained under the driver; each step's loss and the final
# parameters go to files the test reads
_CHAOS_WORKER = r"""
import json, os
import numpy as np
import torch
from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.resilience import ResilientTrainLoop

torch.manual_seed(0)
TOTAL = int(os.environ["CHAOS_TOTAL"])
model = torch.nn.Linear(4, 4)
opt = AdamW(learning_rate=0.05, parameters=model.parameters())
loop = ResilientTrainLoop(None, lambda: {"model": model.state_dict(),
                                         "opt": opt.state_dict()},
                          save_every=1, keep_last_k=100,
                          heartbeat_interval=0.1)
start = loop.restore()
info = ckpt.last_load_info() or {}
with open(os.environ["RUNS_FILE"], "a") as f:
    f.write(json.dumps({"start": start, "loaded": info.get("version")})
            + "\n")
for step in range(start, TOTAL):
    g = torch.Generator().manual_seed(step)
    x = torch.randn(8, 4, generator=g)
    loss = (model(x) - x.flip(1)).square().mean()
    loss.backward()
    opt.step()
    opt.clear_grad()
    with open(os.environ["TRAJ_FILE"], "a") as f:
        f.write(f"{step} {loss.item()!r}\n")
    loop.end_step(step, loss=loss.item())
np.savez(os.environ["FINAL_FILE"], **{n: p.detach().numpy()
                                      for n, p in model.named_parameters()})
loop.finish()
"""


def _supervised(tmp_path, tag, schedule):
    d = tmp_path / tag
    d.mkdir()
    script = d / "worker.py"
    script.write_text(_CHAOS_WORKER)
    files = {k: str(d / f"{k}.txt") for k in ("runs", "traj")}
    report = run_resilient(
        str(script), ckpt_dir=str(d / "ck"), fault_schedule=schedule,
        max_restarts=3, restart_backoff_s=0.2, heartbeat_timeout=1.5,
        poll_interval=0.1, log_dir=str(d / "logs"),
        env={"CHAOS_TOTAL": "6", "RUNS_FILE": files["runs"],
             "TRAJ_FILE": files["traj"], "FINAL_FILE": str(d / "final.npz"),
             "PYTHONPATH": _REPO})
    log = os.path.join(str(d / "logs"), "workerlog.0")
    assert report.code == 0, (report, open(log).read()[-3000:])
    runs = [json.loads(line) for line in open(files["runs"])]
    traj = {}
    for line in open(files["traj"]):
        s, v = line.split()
        traj.setdefault(int(s), []).append(float(v))
    return report, runs, traj, dict(np.load(str(d / "final.npz"))), \
        str(d / "ck")


def test_chaos_stall_and_crash_mid_save_resume_to_the_target(tmp_path):
    clean, runs0, traj0, final0, _ = _supervised(tmp_path, "clean", None)
    assert isinstance(clean, RunReport) and clean.restarts == 0
    assert runs0 == [{"start": 0, "loaded": None}]
    report, runs, traj, final, ck = _supervised(
        tmp_path, "chaos", "step@2=stall:120;ckpt_write@3=crash")
    assert report.stalls >= 1 and report.crashes >= 1, report
    assert report.events[-1] == "completed"
    # every relaunch resumed from a COMMITTED version, never the torn one
    assert len(runs) == 3, runs
    assert runs[0] == {"start": 0, "loaded": None}
    for e in runs[1:]:
        assert e["loaded"] is not None
        assert os.path.exists(os.path.join(ck, e["loaded"],
                                           ckpt.COMMIT_FILE))
        assert e["start"] == int(e["loaded"]) + 1
    assert runs[2]["loaded"] == "2", runs    # the torn "3" skipped
    # the trajectory and the end state of the uninterrupted run, exactly
    assert set(traj) == set(range(6))
    for s, vs in traj.items():
        assert all(v == traj0[s][0] for v in vs), (s, vs, traj0[s])
    assert set(final) == set(final0)
    for n, a in final.items():
        assert np.array_equal(a, final0[n]), n
    for d in os.listdir(ck):
        assert os.path.exists(os.path.join(ck, d, ckpt.COMMIT_FILE)), d
