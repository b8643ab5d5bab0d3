"""The port's expert parallelism across 4 gloo ranks against the JAX
package's ERNIE-MoE at dp 2 x ep 4 on its 8 virtual devices.

One 4-rank group (``tests/torch_dist_workers.py moe``, started by the
port's launcher with ``--device cpu``) trains the tiny ERNIE-MoE (2 MoE
blocks of 8 experts, GShard top-2, dropout 0) for 3 AdamW steps with
``ClipGradForMOEByGlobalNorm`` under ``fleet.init`` at ep 4 (dp 1, two
experts a rank) and dp 2 x ep 2, each through ``train_step(mesh=...)``
on one global batch of 8 x 16.  The weights are the JAX model's (seed
5), carried through an ``.npz``, each rank taking its experts.  The
JAX package computes the same math at any layout, so both runs are held
to its dp 2 x ep 4 run.

What makes the comparison bite: ``capacity_factor`` 0.5 drops at least
half of the 256 choices (``cap`` 16 a expert over the global 128
tokens), and the MLM labels keep ~25 % of the first four rows and ~60 %
of the last four, so the two dp ranks count unequally.  Two controls in
the ranks compute the capacity and queue places, or the gates' aux loss,
per dp rank (the upstream GPU form); their losses (the capacity's) or
gate losses (the aux loss's) must miss the JAX run.  The ranks also
record the eval loss and each gate loss on their own rows (the global
values), the MoE clip's norm after one backward at
ep 4 (the plain clip refuses there), and the ragged ``global_scatter``
/ ``global_gather`` on 4 ranks, held against a numpy model of the
exchange.

Tolerances (``PERF.md``, "Parity tolerances"): losses ``rtol = 2e-4``
and parameters ``atol = 1e-4`` (the tensor-parallel runs'); the eval
losses and the clip's norm ``rtol = 1e-5`` (fp32, one forward); the
exchange exactly.
"""
import types

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.communication.group import _reset_groups
from paddle_tpu.distributed.fleet.base.topology import _clear_hcg
from paddle_tpu.distributed.mesh import reset_mesh
from paddle_tpu.incubate.distributed.models.moe import (
    ClipGradForMOEByGlobalNorm as JaxMoEClip)
from paddle_tpu.jit import train_step as jax_train_step
from paddle_tpu.models import ErnieMoEForPretraining as JaxErnie
from paddle_tpu.models import ernie_moe_config as jax_ernie_config

import paddle_tpu_torch.distributed as tdist
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
from paddle_tpu_torch.nn import GELU, Linear

import torch_dist_workers as workers
from torch_dist_workers import launch, wait_ranks

N = workers.N_RANKS
RUNS = list(workers.MOE_RUNS)
LOSS_RTOL = 2e-4
PARAM_ATOL = 1e-4
EVAL_RTOL = 1e-5
SEED = 5
EXPERTS = 8


def _fresh():
    reset_mesh()
    _reset_groups()
    _clear_hcg()


def _jax_model():
    paddle.seed(SEED)
    return JaxErnie(jax_ernie_config("tiny", **workers.MOE_CFG))


def _jax_side(weights):
    """The JAX package's eval losses, gradient norm and dp 2 x ep 4
    training run on the global batch."""
    ids, labels = workers.moe_batch(256)
    _fresh()
    m = _jax_model()
    m.eval()
    loss = m.loss_fn(m(Tensor(ids)), Tensor(labels))
    evals = [float(loss)] + [float(g) for g in m.ernie.gate_losses()]
    m.train()
    m.loss_fn(m(Tensor(ids)), Tensor(labels)).backward()
    norm = float(np.sqrt(sum(
        float((np.asarray(p.grad._data, np.float64) ** 2).sum())
        for p in m.parameters() if p.grad is not None)))
    s = jfleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 2, "ep_degree": 4, "mp_degree": 1,
                        "pp_degree": 1, "sharding_degree": 1}
    jfleet.init(is_collective=True, strategy=s)
    m = _jax_model()
    for n, p in m.state_dict().items():
        np.testing.assert_array_equal(np.asarray(p._data), weights[n])
    opt = jopt.AdamW(learning_rate=workers.LR, parameters=m.parameters(),
                     weight_decay=0.01,
                     grad_clip=JaxMoEClip(workers.MOE_CLIP))
    step = jax_train_step(m, m.loss_fn, opt)
    losses = [float(step(ids, labels)) for _ in range(workers.STEPS)]
    params = {n: np.asarray(p._data) for n, p in m.named_parameters()}
    _fresh()
    return dict(eval=evals, norm=norm, losses=losses, params=params)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("expert_parallel")
    _fresh()
    weights = {k: np.asarray(v._data)
               for k, v in _jax_model().state_dict().items()}
    np.savez(out / "ernie.npz", **weights)
    proc = launch("moe", out, out / "logs", str(out), threads=2)
    try:
        want = _jax_side(weights)
    except BaseException:
        proc.kill()
        proc.communicate()
        raise
    arrays, info = wait_ranks(proc, out, out / "logs")
    return want, arrays, info


def _held(arrays, tag):
    return {k[len(tag) + 1:]: v for k, v in arrays.items()
            if k.startswith(tag + "/")}


def _is_expert(name):
    return ".ffn.experts." in name


def _ep_rank(info, tag, r):
    return info[r][f"{tag}_groups"]["ep_rank"]


@pytest.mark.parametrize("tag", RUNS)
def test_moe_losses_match_jax(runs, tag):
    want, _, info = runs
    for r in range(N):
        np.testing.assert_allclose(info[r][tag], want["losses"],
                                   rtol=LOSS_RTOL, err_msg=f"rank {r}")
    assert info[0][tag][-1] < info[0][tag][0]


@pytest.mark.parametrize("tag", RUNS)
def test_moe_parameters_match_jax(runs, tag):
    """Every rank's dense parameters and its experts (by global index)
    after 3 steps."""
    want, arrays, _ = runs
    for r in range(N):
        for name, a in _held(arrays[r], tag).items():
            np.testing.assert_allclose(a, want["params"][name], rtol=0,
                                       atol=PARAM_ATOL,
                                       err_msg=f"rank {r} {name}")


@pytest.mark.parametrize("tag", RUNS)
def test_dense_parameters_bit_identical_across_ep_group(runs, tag):
    _, arrays, info = runs
    for r in range(N):
        for q in info[r][f"{tag}_groups"]["ep"]:
            mine, theirs = _held(arrays[r], tag), _held(arrays[q], tag)
            for name, a in mine.items():
                if not _is_expert(name):
                    np.testing.assert_array_equal(a, theirs[name],
                                                  err_msg=name)


@pytest.mark.parametrize("tag", RUNS)
def test_each_rank_holds_its_experts(runs, tag):
    """Rank with ep coordinate j holds experts ``j * E / ep`` to ``(j + 1)
    * E / ep - 1`` of every MoE block, under their global names."""
    _, arrays, info = runs
    ep = len(info[0][f"{tag}_groups"]["ep"])
    per = EXPERTS // ep
    for r in range(N):
        j = _ep_rank(info, tag, r)
        mine = list(range(j * per, (j + 1) * per))
        assert info[r][f"{tag}_experts"] == [mine, mine]
        held = {int(n.split(".ffn.experts.")[1].split(".")[0])
                for n in _held(arrays[r], tag) if _is_expert(n)}
        assert held == set(mine)


def test_own_init_is_the_same_at_ep4(runs):
    """The port's own init at ep 4 (no carry): every rank's experts and
    dense weights equal a world-of-one model's, by global name."""
    from paddle_tpu_torch.models import (ErnieMoEForPretraining,
                                         ernie_moe_config)
    one = dict(ErnieMoEForPretraining(ernie_moe_config("tiny"),
                                      device="cpu").named_parameters())
    _, arrays, _ = runs
    for r in range(N):
        held = _held(arrays[r], "own")
        assert sum(_is_expert(n) for n in held) == \
            sum(_is_expert(n) for n in one) // N
        for name, a in held.items():
            np.testing.assert_array_equal(a, one[name].detach().numpy(),
                                          err_msg=name)


@pytest.mark.parametrize("tag", RUNS)
def test_eval_loss_and_gate_losses_are_global(runs, tag):
    """Each rank's criterion on its own rows, averaged over the dp group
    as ``train_step`` averages it, and its aux losses are the global
    batch's: the masked mean over unequal label counts, the aux loss's
    means over every token."""
    want, _, info = runs
    for r in range(N):
        np.testing.assert_allclose(info[r][f"{tag}_eval"], want["eval"],
                                   rtol=EVAL_RTOL, err_msg=f"rank {r}")


def test_moe_clip_norm_is_global(runs):
    """At ep 4 each rank holds 2 of 8 experts; the MoE clip's norm is the
    JAX package's global one, and the plain clip refuses."""
    want, _, info = runs
    for r in range(N):
        np.testing.assert_allclose(info[r]["moe_norm"], want["norm"],
                                   rtol=EVAL_RTOL)
        assert "ClipGradForMOEByGlobalNorm" in info[r]["plain_clip"]
    assert want["norm"] > workers.MOE_CLIP          # the clip bites


@pytest.mark.parametrize("ctl", workers.MOE_CONTROLS)
def test_per_rank_controls_miss_jax(runs, ctl):
    """Capacity and places per dp rank: the training losses leave the
    tolerance the real runs hold.  The aux loss per dp rank: the gate
    losses leave theirs (weighted by 0.01 in the criterion, they move the
    training losses less)."""
    want, _, info = runs
    for r in range(N):
        if ctl == "per_rank_capacity":
            got, ref, tol = info[r][ctl], want["losses"], LOSS_RTOL
        else:
            got, ref, tol = info[r][f"{ctl}_eval"][1:], want["eval"][1:], \
                EVAL_RTOL
        assert not np.allclose(got, ref, rtol=tol, atol=0), (ctl, got, ref)


def test_batch_drops_tokens_and_counts_unequally():
    ids, labels = workers.moe_batch(256)
    half = workers.GLOBAL_BATCH // 2
    assert (labels[:half] != -100).sum() != (labels[half:] != -100).sum()
    t, k = ids.size, 2
    cap = int(np.ceil(k * t / EXPERTS * workers.MOE_CFG["capacity_factor"]))
    assert EXPERTS * cap < k * t


def test_topology_groups(runs):
    """ep 4: one ep group of every rank; dp 2 x ep 2: ep groups {0, 1},
    {2, 3} and dp groups {0, 2}, {1, 3} (the JAX axis order)."""
    _, _, info = runs
    for r in range(N):
        g = info[r]["ep4_groups"]
        assert g["ep"] == [0, 1, 2, 3] and g["dp"] == [r]
        g = info[r]["dp2_ep2_groups"]
        assert g["ep"] == [r - r % 2, r - r % 2 + 1]
        assert g["dp"] == [r % 2, r % 2 + 2]
        assert g["ep_rank"] == r % 2


def test_global_scatter_gather_match_numpy(runs):
    """Rank d receives, expert-major then by source rank, the rows every
    rank sent to its experts; the gather returns each rank its rows; the
    gradient of the scatter is the gather of the output's gradient."""
    _, arrays, _ = runs
    counts = workers.moe_a2a_counts()
    for d in range(N):
        want = [[s, d, e, i] for e in range(workers.MOE_A2A_EXPERTS)
                for s in range(N) for i in range(counts[s, d, e])]
        np.testing.assert_array_equal(
            arrays[d]["a2a/scatter"],
            np.array(want, np.float32).reshape(-1, 4))
        x = workers.moe_a2a_rows(d, counts)
        np.testing.assert_array_equal(arrays[d]["a2a/gather"], x)
        np.testing.assert_array_equal(arrays[d]["a2a/grad"], 2 * x + 1)


@pytest.mark.parametrize("degree", ["pp_degree", "sharding_degree",
                                    "mp_degree", "sep_degree", "cp_degree"])
def test_ep_with_other_axes_raises(degree):
    """An expert degree above 1 with a pp, sharding, mp, sep or cp degree
    above 1 is refused before the rank count is read."""
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 1, "ep_degree": 2, degree: 2}
    try:
        with pytest.raises(NotImplementedError,
                           match="expert degree above 1"):
            fleet.init(is_collective=True, strategy=s, device="cpu")
    finally:
        tdist.destroy_process_group()


def test_uneven_expert_split_raises():
    """8 experts over an ep group of 3 ranks."""
    experts = [torch.nn.Sequential(Linear(4, 8, device="cpu"), GELU(),
                                   Linear(8, 4, device="cpu"))
               for _ in range(EXPERTS)]
    group = types.SimpleNamespace(nranks=3, rank=0)
    with pytest.raises(NotImplementedError, match="expert degree of 3"):
        MoELayer(4, experts, moe_group=group, device="cpu")
