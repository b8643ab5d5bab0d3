"""The port's semi-auto API and ``Engine`` across 4 gloo ranks against
the JAX package on its 8 virtual devices.

One 4-rank group (``tests/torch_dist_workers.py auto_parallel``, through
the port's launcher with ``--device cpu``) runs:

* ``shard_tensor`` / ``reshard`` / ``unshard_dtensor`` on a 2 x 2 mesh
  (``Shard`` on either or both dims, ``Replicate``, ``Partial``) and
  to a 1-d mesh over the same ranks and back: each rank's piece against
  a numpy model of the placements, every global value exact;
* ``tests/test_auto_parallel.py``'s Linear-GELU-Linear stack annotated
  at dp 2 x mp 2 (``ProcessMesh([[0, 1], [2, 3]], ["dp", "mp"])``, the
  first bias split or replicated), through ``train_step`` and
  ``Engine.fit``, against the JAX package's semi-auto run on a 4-device
  ``ProcessMesh`` and against the port's dp 4 (losses ``rtol 2e-4``,
  parameters ``atol 1e-4``); a rank holds half the split weights;
* placements outside the rule table (a data dim, two mesh dims,
  ``Partial``) raising ``NotImplementedError``;
* the tiny ERNIE-MoE (``tests/test_torch_expert_parallel.py``'s weights,
  batch and clip) through ``Engine.fit`` at dp 2 x ep 2 against the JAX
  ``Engine.fit`` at dp 2 x ep 4 (``rtol 2e-4``), and bit-equal to the
  port's own ``train_step`` run;
* ``Engine.tune`` with ``_card_backend`` patched: an explicit list of
  four candidates measured in full, the mp candidate of a plain model
  run, the auto-enumerated space capped at 3, ``profile`` with
  ``top_k=2``, a zero budget; every rank installing the same winner,
  the parameters bit-equal after the trials and no reducer or gradient
  hook left.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.distributed import auto_parallel as jap
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.communication.group import _reset_groups
from paddle_tpu.distributed.fleet.base.topology import _clear_hcg
from paddle_tpu.distributed.mesh import reset_mesh
from paddle_tpu.incubate.distributed.models.moe import (
    ClipGradForMOEByGlobalNorm as JaxMoEClip)
from paddle_tpu.jit import train_step as jax_train_step
from paddle_tpu.models import ErnieMoEForPretraining as JaxErnie
from paddle_tpu.models import ernie_moe_config as jax_ernie_config

import torch_dist_workers as workers
from torch_dist_workers import launch, wait_ranks

N = workers.N_RANKS
LOSS_RTOL = 2e-4
PARAM_ATOL = 1e-4
MLP_SEED = 21
MOE_SEED = 5


def _fresh():
    reset_mesh()
    _reset_groups()
    _clear_hcg()
    jap.api._auto_mesh = None


def _mse(out, y):
    return ((out - y) ** 2).mean()


def _jax_mlp():
    paddle.seed(MLP_SEED)
    a, h, b = workers.AP_MLP
    return jnn.Sequential(jnn.Linear(a, h), jnn.GELU(), jnn.Linear(h, b))


def _jax_semi_auto():
    """The JAX package's semi-auto run on a 4-device ProcessMesh."""
    _fresh()
    mesh = jap.ProcessMesh([[0, 1], [2, 3]], dim_names=["dp", "mp"])
    jap.set_mesh(mesh)
    m = _jax_mlp()
    jap.shard_tensor(m[0].weight, mesh, [jap.Replicate(), jap.Shard(1)])
    jap.shard_tensor(m[0].bias, mesh, [jap.Replicate(), jap.Shard(0)])
    jap.shard_tensor(m[2].weight, mesh, [jap.Replicate(), jap.Shard(0)])
    o = jap.shard_optimizer(jopt.AdamW(learning_rate=workers.LR,
                                       parameters=m.parameters()))
    step = jax_train_step(m, _mse, o, mesh=mesh.jax_mesh)
    x, y = workers.ap_data()
    losses = [float(step(x, y)) for _ in range(workers.AP_STEPS)]
    params = {n: np.asarray(p._data) for n, p in m.named_parameters()}
    _fresh()
    return losses, params


def _jax_moe_engine():
    """The JAX ``Engine.fit`` on the tiny ERNIE-MoE at dp 2 x ep 4."""
    _fresh()
    s = jfleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 2, "ep_degree": 4, "mp_degree": 1,
                        "pp_degree": 1, "sharding_degree": 1}
    jfleet.init(is_collective=True, strategy=s)
    paddle.seed(MOE_SEED)
    m = JaxErnie(jax_ernie_config("tiny", **workers.MOE_CFG))
    opt = jopt.AdamW(learning_rate=workers.LR, parameters=m.parameters(),
                     weight_decay=0.01,
                     grad_clip=JaxMoEClip(workers.MOE_CLIP))
    batch = workers.moe_batch(256)

    class DS:
        def __len__(self):
            return workers.STEPS

        def __getitem__(self, i):
            return batch
    losses = jap.Engine(m, loss=m.loss_fn, optimizer=opt).fit(
        DS(), batch_size=None)["loss"]
    _fresh()
    return losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("auto_parallel")
    _fresh()
    np.savez(out / "mlp.npz", **{n: np.asarray(p._data) for n, p in
                                 _jax_mlp().named_parameters()})
    paddle.seed(MOE_SEED)
    ernie = JaxErnie(jax_ernie_config("tiny", **workers.MOE_CFG))
    np.savez(out / "ernie.npz", **{k: np.asarray(v._data)
                                   for k, v in ernie.state_dict().items()})
    proc = launch("auto_parallel", out, out / "logs", str(out), threads=2)
    try:
        want = dict(semi=_jax_semi_auto(), moe=_jax_moe_engine())
    except BaseException:
        proc.kill()
        proc.communicate()
        raise
    arrays, info = wait_ranks(proc, out, out / "logs")
    return want, arrays, info


def _np_local(full, spec, rank):
    """Rank ``rank``'s piece on the 2 x 2 mesh [[0, 1], [2, 3]]."""
    coord = divmod(rank, 2)
    x = full
    for (kind, d), c in zip(spec, coord):
        if kind == "S":
            k = x.shape[d] // 2
            x = np.take(x, range(c * k, (c + 1) * k), axis=d)
        elif kind == "P" and c:
            x = np.zeros_like(x)
    return x


def test_shard_and_reshard_round_trips_are_exact(runs):
    _, arrays, info = runs
    full = np.arange(np.prod(workers.AP_FULL), dtype=np.float32).reshape(
        workers.AP_FULL) - 40.0
    for r in range(N):
        assert info[r]["roundtrips_exact"], f"rank {r}"
        for tag, spec in workers.AP_PLACEMENTS.items():
            np.testing.assert_array_equal(arrays[r][f"rt/{tag}"],
                                          _np_local(full, spec, r))
            np.testing.assert_array_equal(
                arrays[r][f"rt/s0_s1->{tag}"], _np_local(full, spec, r))
            np.testing.assert_array_equal(arrays[r][f"rt/{tag}->line"],
                                          full[2 * r:2 * r + 2])
        assert "does not split" in info[r]["odd_split"]


def test_semi_auto_stack_matches_jax_and_dp4(runs):
    want, arrays, info = runs
    jax_losses, jax_params = want["semi"]
    for r in range(N):
        for key in ("semi", "semi_bias_replicated", "semi_engine", "dp4",
                    "dp4_engine"):
            np.testing.assert_allclose(info[r][key], jax_losses,
                                       rtol=LOSS_RTOL,
                                       err_msg=f"rank {r} {key}")
        assert info[r]["semi_engine"] == info[r]["semi"]
        for n, p in jax_params.items():
            np.testing.assert_allclose(arrays[r][f"semi/{n}"], p,
                                       atol=PARAM_ATOL, err_msg=n)
            np.testing.assert_allclose(arrays[r][f"dp4/{n}"], p,
                                       atol=PARAM_ATOL, err_msg=n)
    assert info[0]["semi"][-1] < info[0]["semi"][0]


def test_semi_auto_ranks_hold_their_halves(runs):
    _, arrays, info = runs
    a, h, b = workers.AP_MLP
    split = a * h + h + h * b
    assert info[0]["dp4_param_numel"] == split + b
    assert info[0]["mp_param_numel"] == split // 2 + b
    for r in range(N):
        mp = r % 2
        full = arrays[r]["semi/0.weight"]
        np.testing.assert_array_equal(arrays[r]["semi_local/0.weight"],
                                      full[:, mp * h // 2:(mp + 1) * h // 2])
        np.testing.assert_array_equal(arrays[r]["semi_local/2.weight"],
                                      arrays[r]["semi/2.weight"]
                                      [mp * h // 2:(mp + 1) * h // 2])


def test_engine_evaluate_and_predict_on_four_ranks(runs):
    _, arrays, info = runs
    for r in range(N):
        np.testing.assert_allclose(arrays[r]["dp4_predict"],
                                   arrays[r]["dp4_forward"], rtol=1e-6,
                                   atol=1e-6)
        assert np.isfinite(info[r]["dp4_engine_eval"])
        np.testing.assert_allclose(info[r]["semi_engine_eval"],
                                   info[r]["dp4_engine_eval"], rtol=1e-5)


@pytest.mark.parametrize("tag,match", [("data_dim", "mesh dim 'dp'"),
                                       ("two_dims", "rule table"),
                                       ("partial", "Partial")])
def test_placements_outside_the_rule_table_raise(runs, tag, match):
    _, _, info = runs
    for r in range(N):
        msg = info[r]["refusals"][tag]
        assert msg is not None and match in msg, (r, msg)
        assert "0.weight" in msg


def test_moe_engine_fit_matches_jax_and_train_step(runs):
    want, _, info = runs
    for r in range(N):
        np.testing.assert_allclose(info[r]["moe_engine"], want["moe"],
                                   rtol=LOSS_RTOL, err_msg=f"rank {r}")
        assert info[r]["moe_engine"] == info[r]["moe_step"]
        time_ms, mem = info[r]["moe_engine_cost"]
        assert time_ms > 0 and mem > 0
    assert info[0]["moe_engine"][-1] < info[0]["moe_engine"][0]


def _measured(report):
    return [e for e in report if "step_s" in e]


def test_tune_measures_an_explicit_list_and_restores(runs):
    _, _, info = runs
    winners = {tuple(info[r]["tune_winner"]) for r in range(N)}
    assert len(winners) == 1
    for r in range(N):
        rep = info[r]["tune_explicit"]
        assert len(_measured(rep)) == len(workers.AP_TUNE), rep
        assert not [e for e in rep if "skipped" in e or "error" in e]
        assert info[r]["tune_bit_equal"]
        assert info[r]["tune_reducers_left"] == 0
        assert info[r]["tune_hooks_left"] == 0
        assert np.isfinite(info[r]["tune_fit"]).all()
        assert [e["step_s"] for e in _measured(rep)] == \
            [e["step_s"] for e in _measured(info[0]["tune_explicit"])]


def test_tune_caps_the_auto_space_and_honours_top_k_and_budget(runs):
    _, _, info = runs
    for r in range(N):
        auto = info[r]["tune_auto"]
        assert len(auto) == 6 and len(_measured(auto)) == 3, auto
        assert len([e for e in auto if e.get("skipped", "").startswith(
            "below top_k")]) == 3
        assert any(e["mp"] > 1 for e in _measured(auto) + _measured(
            info[r]["tune_explicit"]))
        top = info[r]["tune_top_k"]
        assert len(_measured(top)) == 2 and len(top) == 4, top
        budget = info[r]["tune_budget"]
        assert len(_measured(budget)) == 1
        assert len([e for e in budget if e.get("skipped") ==
                    "tuning budget exhausted"]) == 3
