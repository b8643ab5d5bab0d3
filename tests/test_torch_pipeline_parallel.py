"""The port's pipeline parallelism across 4 gloo ranks (one process a
stage, activations and gradients over the topology's p2p channels)
against the JAX package.

One 4-rank group (``tests/torch_dist_workers.py pipeline``, started by
the port's launcher with ``--device cpu``):

* ``tests/test_pp_schedules.py``'s ``PipelineLayer`` (8 x ``Linear(8,
  8)``, SGD lr 0.05, 3 steps of ``train_batch`` on batches of 8 in 4
  micro-batches) at pp 4 through ``fleet.distributed_model``
  (``PipelineParallel``) under FThenB, 1F1B, ZBH1 and VPP (2 virtual
  stages a rank), each rank building its own stage only, against the
  JAX package's runs at pp 4: losses, every stage's parameters, each
  rank's event order (the JAX event log's events of the rank's virtual
  stages, in order) and its peak of live residuals (counted over the
  same events); the schedules' parameters bit-equal to one another;
* a ``SharedLayerDesc`` (layers 0 and 7 one bias-free ``Linear``) at pp
  4: the summed gradient of the first step and 3 steps through
  ``fleet.distributed_optimizer``, against the JAX run (one object);
* an explicit schedule with a live mp axis (pp 2 x mp 2) refused, then
  run under ``FLAGS_pp_allow_axis_fallback``; pp with sharding, sep or
  cp refused;
* the ``Linear`` stack at pp 4 under 1F1B with ``ClipGradByGlobalNorm(
  0.5)`` in its SGD (bare, and through ``fleet.distributed_optimizer``):
  losses and parameters against the JAX stack with the same clip on one
  device (its clip sums arrays on one device: at pp 4 over four it
  raises), each step's global norm (the stages' shares summed over pp)
  against the JAX gradients' norm within ``rtol = 1e-5``, a stage's own
  share missing it;
* the tiny GPT (4 layers, head tied to the word embedding) at dp 2 x pp 2
  through ``gpt_pipeline_step`` against the JAX package's at dp 2 x pp 4
  (``test_pipeline_spmd.py``'s run: AdamW 1e-3, 4 micro-batches of the
  8 x 32 batch): losses and every parameter a rank stepped;
* the tiny GQA LLaMA (4 layers, 4 heads over 2) at mp 2 x pp 2 through
  ``llama_pipeline_step``, its stages on the mp layers, against the JAX
  package's at dp 2 x mp 2 x pp 2 (``test_llama.py``'s batch, 8 x 16).

The JAX runs' degrees differ from the port's where its 8-device fleet
needs them to; every layout computes the same global mean.
Tolerances: the ``Linear`` stack's losses ``rtol = 1e-5`` and
parameters ``atol = 1e-6`` (fp32, the same products); the pipeline
steps' losses ``rtol = 3e-4`` (``test_pipeline_spmd.py``'s) and
parameters after 3 AdamW steps ``atol = 1e-4`` (``test_torch_zero3.py``'s):
fp32 in another summation order (the JAX ring's psums, the port's
per-micro-batch accumulation).
"""
import jax
import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.communication.group import _reset_groups
from paddle_tpu.distributed.fleet import LayerDesc as JaxLayerDesc
from paddle_tpu.distributed.fleet import PipelineLayer as JaxPipelineLayer
from paddle_tpu.distributed.fleet import SharedLayerDesc as JaxSharedLayerDesc
from paddle_tpu.distributed.fleet.base.topology import _clear_hcg
from paddle_tpu.distributed.fleet.meta_parallel.pp_schedules import (
    HostPipelineSchedule as JaxHostPipelineSchedule)
from paddle_tpu.distributed.fleet.meta_parallel.pp_spmd import (
    gpt_pipeline_step as jax_gpt_pipeline_step)
from paddle_tpu.distributed.mesh import reset_mesh
from paddle_tpu.models import GPTForPretraining as JaxGPT
from paddle_tpu.models import gpt_config as jax_gpt_config
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_config as jax_llama_config
from paddle_tpu.models import llama_pipeline_step as jax_llama_pipeline_step

import torch_dist_workers as workers
from torch_dist_workers import launch, wait_ranks

N = workers.N_RANKS
MODES = list(workers.PP_MODES)
LIN_LOSS_RTOL = 1e-5
LIN_PARAM_ATOL = 1e-6
LOSS_RTOL = 3e-4
PARAM_ATOL = 1e-4


def _fresh():
    reset_mesh()
    _reset_groups()
    _clear_hcg()


def _jax_fleet(degrees, pipeline_configs=None):
    _fresh()
    s = jfleet.DistributedStrategy()
    s.hybrid_configs = dict(degrees)
    if pipeline_configs is not None:
        s.pipeline_configs = pipeline_configs
    jfleet.init(is_collective=True, strategy=s)
    return jfleet.get_hybrid_communicate_group()


def _jax_layer_run(mode):
    """``test_pp_schedules.py``'s run of ``mode`` at pp 4."""
    _jax_fleet({"dp_degree": -1, "pp_degree": 4},
               {"micro_batch_size": 2, "accumulate_steps": 4,
                "schedule_mode": mode})
    paddle.seed(3)
    pl = JaxPipelineLayer(
        layers=[JaxLayerDesc(jnn.Linear, 8, 8) for _ in range(8)],
        loss_fn=workers.pp_loss,
        num_virtual_pipeline_stages=2 if mode == "VPP" else 1)
    weights = {k: np.asarray(v._data) for k, v in pl.state_dict().items()}
    model = jfleet.fleet.distributed_model(pl)
    o = jopt.SGD(learning_rate=0.05, parameters=pl.parameters())
    losses = []
    for i in range(workers.STEPS):
        x, y = workers.pp_data(i)
        losses.append(float(model.train_batch(
            (paddle.to_tensor(x), paddle.to_tensor(y)), o)))
    out = dict(weights=weights, losses=losses,
               params={n: np.asarray(p._data)
                       for n, p in pl.named_parameters()},
               log=[tuple(e) for e in model._host_sched.event_log])
    _fresh()
    return out


def _jax_clip_run(weights):
    """The ``Linear`` stack (``weights``) under 1F1B with SGD and
    ``ClipGradByGlobalNorm(PP_CLIP)``, every stage on one device: the JAX
    clip sums its arrays on one device, so its run at pp 4 over four
    devices raises and this is its global-norm oracle.  Losses, each
    step's global norm (of the gradients the step clips), parameters."""
    _fresh()
    pl = JaxPipelineLayer(
        layers=[JaxLayerDesc(jnn.Linear, 8, 8) for _ in range(8)],
        num_stages=4, loss_fn=workers.pp_loss)
    pl.set_state_dict({k: paddle.to_tensor(v) for k, v in weights.items()})
    sched = JaxHostPipelineSchedule(pl, "1F1B",
                                    devices=[jax.devices()[0]] * 4)
    o = jopt.SGD(learning_rate=0.05, parameters=pl.parameters(),
                 grad_clip=jnn.ClipGradByGlobalNorm(workers.PP_CLIP))
    losses, norms = [], []
    for i in range(workers.STEPS):
        x, y = workers.pp_data(i)
        losses.append(float(sched.forward_backward(np.split(x, 4),
                                                   np.split(y, 4))))
        norms.append(float(np.sqrt(sum(
            np.sum(np.asarray(p._grad._data, np.float64) ** 2)
            for p in pl.parameters()))))
        o.step()
        o.clear_grad()
    params = {n: np.asarray(p._data) for n, p in pl.named_parameters()}
    _fresh()
    return dict(losses=losses, norms=norms, params=params)


def _jax_shared_run():
    """The ``SharedLayerDesc`` stack (layers 0 and 7 one bias-free
    ``Linear``) at pp 4 under 1F1B: weights, the first step's gradient of
    the shared weight, then 3 steps' losses and parameters."""
    _fresh()
    paddle.seed(5)
    tied = JaxSharedLayerDesc("tied", jnn.Linear, None, "weight", 8, 8,
                              bias_attr=False)
    pl = JaxPipelineLayer(
        layers=[tied] + [JaxLayerDesc(jnn.Linear, 8, 8) for _ in range(6)]
        + [tied], num_stages=4, loss_fn=workers.pp_loss)
    weights = {k: np.asarray(v._data) for k, v in pl.state_dict().items()}
    # one device for every stage: the shared layer is one object there
    sched = JaxHostPipelineSchedule(pl, "1F1B",
                                    devices=[jax.devices()[0]] * 4)
    o = jopt.SGD(learning_rate=0.05, parameters=pl.parameters())

    def step(i):
        x, y = workers.pp_data(i)
        return sched.forward_backward(np.split(x, 4), np.split(y, 4))
    step(0)
    grad = np.asarray(dict(pl.named_parameters())[
        "0._shared.weight"]._grad._data)
    o.clear_grad()
    losses = []
    for i in range(workers.STEPS):
        losses.append(float(step(i)))
        o.step()
        o.clear_grad()
    params = {n: np.asarray(p._data) for n, p in pl.named_parameters()}
    _fresh()
    return weights, grad, losses, params


def _jax_step_run(kind):
    """The JAX pipeline step of the tiny GPT (dp 2 x pp 4, as
    ``test_pipeline_spmd.py`` runs it) or LLaMA (dp 2 x mp 2 x pp 2):
    initial weights, losses, final parameters."""
    if kind == "gpt":
        hcg = _jax_fleet({"dp_degree": 2, "pp_degree": 4})
        paddle.seed(11)
        model = JaxGPT(jax_gpt_config("tiny", hidden_dropout_prob=0.0,
                                      attention_dropout_prob=0.0,
                                      num_layers=4))
        build, batch = jax_gpt_pipeline_step, workers.pp_batch(512,
                                                               workers.SEQ)
    else:
        hcg = _jax_fleet({"dp_degree": 2, "mp_degree": 2, "pp_degree": 2})
        paddle.seed(3)
        model = JaxLlama(jax_llama_config("tiny", num_layers=4))
        build = jax_llama_pipeline_step
        batch = workers.pp_batch(workers.PP_LLAMA["vocab_size"], 16)
    weights = {k: np.asarray(v._data) for k, v in model.state_dict().items()}
    o = jopt.AdamW(learning_rate=workers.LR, parameters=model.parameters())
    step = build(model, o, hcg.mesh, n_micro=4, dp_axes=("dp",))
    losses = [float(step(*batch)) for _ in range(workers.STEPS)]
    params = {n: np.asarray(p._data) for n, p in model.named_parameters()}
    _fresh()
    return weights, losses, params


def _rank_events(log, r):
    return [e for e in log if e[0] % N == r]


def _peak(events):
    live = peak = 0
    for _, kind, _ in events:
        live += 1 if kind == "F" else -1 if kind in ("B", "Bd") else 0
        peak = max(peak, live)
    return peak


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("pipeline")
    jax = {mode: _jax_layer_run(mode) for mode in MODES}
    jax["clip"] = _jax_clip_run(jax["1F1B"]["weights"])
    np.savez(out / "pp.npz", **jax["1F1B"]["weights"])
    want = {}
    weights, grad, losses, params = _jax_shared_run()
    np.savez(out / "shared.npz", **weights)
    want["shared"] = (grad, losses, params)
    for kind in ("gpt", "llama"):
        weights, losses, params = _jax_step_run(kind)
        np.savez(out / f"{kind}.npz", **weights)
        want[kind] = (losses, params)
    logs = out / "logs"
    proc = launch("pipeline", out, logs, str(out), threads=2)
    arrays, info = wait_ranks(proc, out, logs)
    return jax, want, arrays, info


@pytest.mark.parametrize("mode", MODES)
def test_layer_losses_match_jax(runs, mode):
    jax, _, _, info = runs
    for r in range(N):
        np.testing.assert_allclose(info[r][f"pp4_{mode}"],
                                   jax[mode]["losses"], rtol=LIN_LOSS_RTOL)


@pytest.mark.parametrize("mode", MODES)
def test_layer_parameters_match_jax(runs, mode):
    """Each rank holds its stage's layers only; together they are the
    JAX run's parameters."""
    jax, _, arrays, _ = runs
    held = [sorted(k.split("/", 1)[1] for k in arrays[r]
                   if k.startswith(f"pp4_{mode}/")) for r in range(N)]
    assert sorted(n for h in held for n in h) == sorted(jax[mode]["params"])
    for r in range(N):
        for n in held[r]:
            np.testing.assert_allclose(arrays[r][f"pp4_{mode}/{n}"],
                                       jax[mode]["params"][n], rtol=0,
                                       atol=LIN_PARAM_ATOL,
                                       err_msg=f"rank {r} {n}")


@pytest.mark.parametrize("mode", MODES)
def test_rank_event_order_matches_jax(runs, mode):
    jax, _, _, info = runs
    for r in range(N):
        got = [tuple(e) for e in info[r][f"pp4_{mode}_log"]]
        assert got == _rank_events(jax[mode]["log"], r), r


@pytest.mark.parametrize("mode", MODES)
def test_rank_peak_live_residuals(runs, mode):
    """Counted as the JAX package counts its vjps, over the rank's own
    events: 1F1B at most P - s, FThenB all M micro-batches."""
    jax, _, _, info = runs
    for r in range(N):
        peak = info[r][f"pp4_{mode}_peak"]
        assert peak == _peak(_rank_events(jax[mode]["log"], r)), r
        if mode == "1F1B":
            assert peak == N - r
        if mode == "FThenB":
            assert peak == 4
    if mode == "ZBH1":
        assert all(info[r]["pp4_ZBH1_retained"] > 0 for r in range(N))


def test_schedules_bit_equal_across_ranks(runs):
    """The same losses and parameters bit for bit under every schedule
    (VPP places the layers on other ranks: compared by name)."""
    _, _, arrays, info = runs

    def held(mode):
        return {k.split("/", 1)[1]: v for r in range(N)
                for k, v in arrays[r].items() if k.startswith(f"pp4_{mode}/")}
    base = held("1F1B")
    for mode in MODES:
        for r in range(N):
            assert info[r][f"pp4_{mode}"] == info[r]["pp4_1F1B"], (mode, r)
        got = held(mode)
        assert set(got) == set(base)
        for n, v in base.items():
            assert np.array_equal(got[n], v), (mode, n)


def test_shared_layer_matches_jax(runs):
    """A ``SharedLayerDesc`` held by stages 0 and 3: each builds it, the
    first stage's value is broadcast, the summed gradient
    (``allreduce_shared_weight_gradients``) is the JAX run's (object
    identity there), and 3 steps through the hybrid optimizer keep both
    copies equal to the JAX run's weight."""
    _, want, arrays, info = runs
    grad, losses, params = want["shared"]
    for r in (0, N - 1):
        name = "0._shared.weight" if r == 0 else f"{N * 2 - 1}._shared.weight"
        np.testing.assert_allclose(arrays[r][f"shared_grad/{name}"], grad,
                                   rtol=0, atol=LIN_PARAM_ATOL)
        np.testing.assert_allclose(arrays[r][f"pp4_shared/{name}"],
                                   params["0._shared.weight"], rtol=0,
                                   atol=LIN_PARAM_ATOL)
    for r in range(N):
        np.testing.assert_allclose(info[r]["pp4_shared"], losses,
                                   rtol=LIN_LOSS_RTOL)
        for k, v in arrays[r].items():
            n = k.split("/", 1)[1]
            if k.startswith("pp4_shared/") and "_shared" not in n:
                np.testing.assert_allclose(v, params[n], rtol=0,
                                           atol=LIN_PARAM_ATOL, err_msg=n)


def test_live_mp_refuses_an_explicit_schedule(runs):
    _, _, _, info = runs
    for r in range(N):
        assert "ZBH1" in info[r]["mp_refused"] and \
            "model" in info[r]["mp_refused"]
        assert np.isfinite(info[r]["mp_fallback_loss"])
        assert any("model" in w for w in info[r]["mp_fallback_warnings"])


def test_p2p_groups_are_the_ring_neighbours(runs):
    """``get_p2p_groups``: the previous and next stage on a ring, and
    the two-rank group of each direction (prev / next first)."""
    _, _, _, info = runs
    for r in range(N):
        prev, nxt = (r - 1) % N, (r + 1) % N
        assert info[r]["p2p_groups"] == [
            prev, nxt, sorted([r, nxt]), sorted([r, prev]),
            sorted([r, nxt]), sorted([r, prev])]


@pytest.mark.parametrize("wrap", ["bare", "hybrid"])
def test_pipeline_clips_by_the_global_norm(runs, wrap):
    """At pp 4 each stage holds its own gradients: the clip sums the
    stages' shares, so the losses, the parameters and every step's norm
    are the JAX run's (one object holds every stage's gradients there),
    and a stage's own share misses the norm."""
    jax, _, arrays, info = runs
    want = jax["clip"]
    assert min(want["norms"]) > workers.PP_CLIP      # the clip is active
    tag = f"pp4_clip_{wrap}"
    for r in range(N):
        np.testing.assert_allclose(info[r][tag], want["losses"],
                                   rtol=LIN_LOSS_RTOL)
        norms = np.array(info[r][f"{tag}_norms"])
        np.testing.assert_allclose(norms[:, 0], want["norms"], rtol=1e-5)
        assert np.all(np.abs(norms[:, 1] - norms[:, 0]) > 1e-3 * norms[:, 0])
        for k, a in arrays[r].items():
            if k.startswith(f"{tag}/"):
                n = k.split("/", 1)[1]
                np.testing.assert_allclose(a, want["params"][n], rtol=0,
                                           atol=LIN_PARAM_ATOL,
                                           err_msg=f"rank {r} {n}")


def test_pipeline_with_sharding_sep_or_cp_raises(runs):
    _, _, _, info = runs
    for r in range(N):
        for axis, msg in info[r]["pp_refused"].items():
            assert "pipeline" in msg and "later slice" in msg, (axis, msg)


@pytest.mark.parametrize("kind,tag", [("gpt", "gpt_dp2_pp2"),
                                      ("llama", "llama_mp2_pp2")])
def test_pipeline_step_losses_match_jax(runs, kind, tag):
    _, want, _, info = runs
    for r in range(N):
        np.testing.assert_allclose(info[r][tag], want[kind][0],
                                   rtol=LOSS_RTOL)


@pytest.mark.parametrize("kind,tag", [("gpt", "gpt_dp2_pp2"),
                                      ("llama", "llama_mp2_pp2")])
def test_pipeline_step_parameters_match_jax(runs, kind, tag):
    """Every parameter some rank stepped, against the JAX run's; together
    the ranks stepped them all."""
    _, want, arrays, _ = runs
    seen = set()
    for r in range(N):
        for k, v in arrays[r].items():
            if not k.startswith(tag + "/"):
                continue
            n = k.split("/", 1)[1]
            seen.add(n)
            np.testing.assert_allclose(v, want[kind][1][n], rtol=0,
                                       atol=PARAM_ATOL,
                                       err_msg=f"rank {r} {n}")
    assert seen == set(want[kind][1])


def test_pipeline_steps_hold_their_own_blocks(runs):
    """GPT's tied embedding is summed over ranks {0, 1} and {2, 3} (its
    first and last stage); each LLaMA rank holds its stage's 2 blocks."""
    _, _, _, info = runs
    for r in range(N):
        assert info[r]["gpt_tied_group"] == ([0, 1] if r < 2 else [2, 3])
        assert info[r]["llama_blocks"] == ([0, 1] if r < 2 else [2, 3])
