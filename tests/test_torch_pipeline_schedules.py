"""The port's pipeline schedules in one process (``HostPipelineSchedule``
behind ``PipelineParallel``) against the JAX package's, at
``tests/test_pp_schedules.py``'s sizes: 8 x ``Linear(8, 8)``, 4 stages,
SGD lr 0.05, 3 steps of ``train_batch`` on batches of 8 rows in 4
micro-batches of 2, loss ``mean((o - y)^2)``.

The port's ``PipelineLayer`` takes the JAX one's initial weights (its
``state_dict``, the same names: each layer under its global index).  For
FThenB, 1F1B, ZBH1 and VPP (2 virtual stages a stage, 8 virtual
stages): the losses and parameters after 3 steps, the event log (every
``(stage, kind, micro)`` in the order run, hence each stage's order)
and ``peak_live_residuals``.  Then what only the port has: the schedules'
parameters bit-equal to one another (the same gradients added in the
same order); ZBH1's retained graphs; ``recompute_interval``; and the
raise rules (an unknown mode, VPP without chunks, ``dp_degree``,
``GradScaler``).  The explicit schedule with a live mp axis needs ranks:
``tests/test_torch_pipeline_parallel.py``.

Tolerances: losses ``rtol = 1e-5`` (``test_pp_schedules.py``'s against
its oracle) and parameters ``atol = 1e-6``: fp32, the same products
in another library.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.communication.group import _reset_groups
from paddle_tpu.distributed.fleet import LayerDesc as JaxLayerDesc
from paddle_tpu.distributed.fleet import PipelineLayer as JaxPipelineLayer
from paddle_tpu.distributed.fleet.base.topology import _clear_hcg
from paddle_tpu.distributed.mesh import reset_mesh

from paddle_tpu_torch import optimizer
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.fleet import (LayerDesc, PipelineLayer,
                                                PipelineParallel)
from paddle_tpu_torch.distributed.fleet.meta_parallel.pp_schedules import (
    BWD, BWD_D, BWD_W, FWD, HostPipelineSchedule, global_order)
from paddle_tpu_torch.models import load_paddle_tpu_state

LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-6
MODES = ["FThenB", "1F1B", "ZBH1", "VPP"]


class Linear(torch.nn.Module):
    """``x @ weight + bias`` with Paddle's ``[in, out]`` weight."""

    def __init__(self, n_in, n_out):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.zeros(n_in, n_out))
        self.bias = torch.nn.Parameter(torch.zeros(n_out))

    def forward(self, x):
        return x @ self.weight + self.bias


def _loss_fn(o, y):
    return (o - y).square().mean()


def _fresh():
    reset_mesh()
    _reset_groups()
    _clear_hcg()


def _data(seed=0, batch=8):
    rs = np.random.RandomState(seed)
    return (rs.randn(batch, 8).astype(np.float32),
            rs.randn(batch, 8).astype(np.float32))


def _strategy(mode, accumulate_steps=4):
    s = fleet.DistributedStrategy()
    s.pipeline_configs = {"micro_batch_size": 2,
                          "accumulate_steps": accumulate_steps,
                          "schedule_mode": mode}
    return s


def _jax_run(mode, n_steps=3):
    """``test_pp_schedules.py``'s ``_schedule_losses``: its initial
    weights, losses, final parameters, event log and peak residuals."""
    _fresh()
    s = jfleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": -1, "pp_degree": 4}
    s.pipeline_configs = {"micro_batch_size": 2, "accumulate_steps": 4,
                          "schedule_mode": mode}
    jfleet.init(is_collective=True, strategy=s)
    paddle.seed(3)
    pl = JaxPipelineLayer(
        layers=[JaxLayerDesc(jnn.Linear, 8, 8) for _ in range(8)],
        loss_fn=_loss_fn,
        num_virtual_pipeline_stages=2 if mode == "VPP" else 1)
    weights = {k: np.asarray(v._data) for k, v in pl.state_dict().items()}
    model = jfleet.fleet.distributed_model(pl)
    o = jopt.SGD(learning_rate=0.05, parameters=pl.parameters())
    losses = []
    for i in range(n_steps):
        x, y = _data(i)
        losses.append(float(model.train_batch(
            (paddle.to_tensor(x), paddle.to_tensor(y)), o)))
    sched = model._host_sched
    params = {n: np.asarray(p._data) for n, p in pl.named_parameters()}
    out = dict(weights=weights, losses=losses, params=params,
               log=list(sched.event_log), peak=sched.peak_live_residuals,
               n_virtual=sched.n_virtual)
    _fresh()
    return out


def _port_layer(weights, vpp=1, recompute_interval=0):
    pl = PipelineLayer(layers=[LayerDesc(Linear, 8, 8) for _ in range(8)],
                       num_stages=4, loss_fn=_loss_fn,
                       recompute_interval=recompute_interval,
                       num_virtual_pipeline_stages=vpp)
    load_paddle_tpu_state(pl, weights)
    return pl


def _port_run(mode, weights, n_steps=3, recompute_interval=0):
    pl = _port_layer(weights, 2 if mode == "VPP" else 1, recompute_interval)
    model = PipelineParallel(pl, strategy=_strategy(mode))
    o = optimizer.SGD(learning_rate=0.05, parameters=pl.parameters())
    losses = [float(model.train_batch(_data(i), o)) for i in range(n_steps)]
    sched = model._host_sched
    params = {n: p.detach().numpy().copy() for n, p in pl.named_parameters()}
    return dict(losses=losses, params=params, log=list(sched.event_log),
                peak=sched.peak_live_residuals, n_virtual=sched.n_virtual,
                retained=sched.peak_retained_graphs)


@pytest.fixture(scope="module")
def runs():
    jax = {mode: _jax_run(mode) for mode in MODES}
    port = {mode: _port_run(mode, jax[mode]["weights"]) for mode in MODES}
    return jax, port


@pytest.mark.parametrize("mode", MODES)
def test_losses_match_jax(runs, mode):
    jax, port = runs
    np.testing.assert_allclose(port[mode]["losses"], jax[mode]["losses"],
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("mode", MODES)
def test_parameters_match_jax(runs, mode):
    jax, port = runs
    assert set(port[mode]["params"]) == set(jax[mode]["params"])
    for n, want in jax[mode]["params"].items():
        np.testing.assert_allclose(port[mode]["params"][n], want, rtol=0,
                                   atol=PARAM_ATOL, err_msg=n)


@pytest.mark.parametrize("mode", MODES)
def test_event_log_matches_jax(runs, mode):
    """Every event in the JAX schedule's order: so each stage's order is
    its timetable's, as there."""
    jax, port = runs
    assert port[mode]["log"] == [tuple(e) for e in jax[mode]["log"]]
    assert port[mode]["n_virtual"] == jax[mode]["n_virtual"]
    for s in range(jax[mode]["n_virtual"]):
        assert [e for e in port[mode]["log"] if e[0] == s] == \
            [tuple(e) for e in jax[mode]["log"] if e[0] == s]


@pytest.mark.parametrize("mode", MODES)
def test_peak_live_residuals_match_jax(runs, mode):
    jax, port = runs
    assert port[mode]["peak"] == jax[mode]["peak"]


def test_schedules_are_bit_equal(runs):
    """Every schedule adds each parameter's per-micro-batch gradients in
    micro-batch order: the parameters agree bit for bit."""
    _, port = runs
    base = port["1F1B"]
    for mode in MODES:
        assert port[mode]["losses"] == base["losses"], mode
        for n, v in base["params"].items():
            assert np.array_equal(port[mode]["params"][n], v), (mode, n)


def test_schedules_differ_in_order_and_residuals(runs):
    """FThenB runs every forward before any backward and holds M x S
    residuals; 1F1B interleaves and holds fewer; ZBH1 splits the
    backward and keeps graphs for its deferred weight gradients."""
    _, port = runs
    log_f = port["FThenB"]["log"]
    first_b = next(j for j, (_, k, _i) in enumerate(log_f) if k == BWD)
    assert first_b == 4 * 4
    log_1 = port["1F1B"]["log"]
    last = [(k, i) for s, k, i in log_1 if s == 3]
    assert last[:4] == [(FWD, 0), (BWD, 0), (FWD, 1), (BWD, 1)]
    assert port["1F1B"]["peak"] < port["FThenB"]["peak"]
    kinds = {k for _, k, _i in port["ZBH1"]["log"]}
    assert kinds == {FWD, BWD_D, BWD_W}
    assert port["ZBH1"]["retained"] > 0 and port["1F1B"]["retained"] == 0


def test_recompute_interval_matches(runs):
    """``recompute_interval=1``: each layer recomputed in the backward,
    the same losses and parameters bit for bit."""
    jax, port = runs
    got = _port_run("1F1B", jax["1F1B"]["weights"], recompute_interval=1)
    assert got["losses"] == port["1F1B"]["losses"]
    for n, v in port["1F1B"]["params"].items():
        assert np.array_equal(got["params"][n], v), n


def test_global_order_one_f_one_b_bound():
    """Per stage s, 1F1B holds at most P - s forward residuals and
    FThenB all M (counted over the global order)."""
    p, m = 4, 8
    for mode, bound in (("1F1B", lambda s: p - s), ("FThenB", lambda s: m)):
        live = {s: 0 for s in range(p)}
        peak = dict(live)
        for s, kind, _ in global_order(mode, p, m):
            live[s] += 1 if kind == FWD else -1
            peak[s] = max(peak[s], live[s])
        assert all(peak[s] == bound(s) for s in range(p)), (mode, peak)


def test_unknown_schedule_mode_raises(runs):
    jax, _ = runs
    pl = _port_layer(jax["1F1B"]["weights"])
    model = PipelineParallel(pl, strategy=_strategy("bogus"))
    with pytest.raises(ValueError, match="schedule_mode"):
        model.train_batch(_data(), optimizer.SGD(
            learning_rate=0.1, parameters=pl.parameters()))


def test_vpp_requires_chunks(runs):
    jax, _ = runs
    pl = _port_layer(jax["1F1B"]["weights"])
    with pytest.raises(ValueError, match="VPP"):
        HostPipelineSchedule(pl, schedule_mode="VPP")


def test_in_process_dp_and_scaler_raise(runs):
    jax, _ = runs
    pl = _port_layer(jax["1F1B"]["weights"])
    with pytest.raises(NotImplementedError, match="process"):
        HostPipelineSchedule(pl, dp_degree=2)
    model = PipelineParallel(pl, strategy=_strategy("1F1B"))
    with pytest.raises(NotImplementedError, match="GradScaler"):
        model.train_batch(_data(), optimizer.SGD(
            learning_rate=0.1, parameters=pl.parameters()), scaler=object())


def test_a_stage_runs_its_own_layers_only(runs):
    """A layer the process does not hold is never run."""
    jax, _ = runs
    pl = _port_layer(jax["1F1B"]["weights"])
    pl.run_function[5] = None
    with pytest.raises(RuntimeError, match="own layers"):
        pl.stage_layers(2)
