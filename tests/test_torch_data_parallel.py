"""The port's data-parallel training across 4 gloo ranks against the JAX
package's ``fleet`` runs, and the launcher, ``spawn`` and the device
rule.

One 4-rank group (``tests/torch_dist_workers.py train``, started by the
port's launcher with ``--device cpu``) trains the tiny GPT, its weights
carried from the JAX model of ``tests/test_fleet_engine.py``'s
``_run_losses`` (seed 7, dropout 0, AdamW lr 1e-3), for 3 steps on that
test's global batch 8 x 32, five ways: ``DataParallel`` over each rank's
2 rows (with small buckets, so several launch in turn), ZeRO stage 1
(``group_sharded_parallel(level="os")``) and stage 2 (``"os_g"``),
``TrainStep(mesh=build_mesh({"dp": 4}))`` on the global batch, and
``fleet.init`` with dp 2 x sharding 2 through ``distributed_model`` /
``distributed_optimizer`` and ``TrainStep(mesh=hcg.mesh)``.  The JAX
references are ``_run_losses(dp=8)`` and, for the fleet run,
``_run_losses(dp=2, sharding=4)``: on one controller the mesh shards the
same global batch, so every run computes the same global-mean loss.

Tolerances: losses ``rtol = 2e-4``, the JAX oracle's own between its
meshes; parameters after 3 steps ``atol = 1e-4`` (fp32 in another
summation order; Adam's normalised update turns a last-bit gradient
difference into up to ~1e-5 of a weight per step, as in
``test_torch_gpt_training.py``).  Across ranks the parameters must be
bit-identical, and the sharded optimizers' gathered ``moment1`` equal
to DataParallel's within 1e-6.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.communication.group import _reset_groups
from paddle_tpu.distributed.fleet.base.topology import _clear_hcg
from paddle_tpu.distributed.mesh import reset_mesh
from paddle_tpu.jit import train_step as jax_train_step
from paddle_tpu.models import GPTForPretraining as JaxGPT
from paddle_tpu.models import gpt_config as jax_gpt_config

import paddle_tpu_torch.distributed as tdist
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.fleet.base.topology import (
    CommunicateTopology)
from paddle_tpu_torch.distributed.launch import launch as tlaunch

import torch_dist_workers as workers
from torch_dist_workers import launch, wait_ranks

N = workers.N_RANKS
MODES = ["dp", "os", "os_g", "mesh", "fleet"]
LOSS_RTOL = 2e-4
PARAM_ATOL = 1e-4


def _fresh():
    reset_mesh()
    _reset_groups()
    _clear_hcg()


def _jax_run(**hybrid):
    """``tests/test_fleet_engine.py``'s ``_run_losses``, also returning
    the initial weights and the final parameters."""
    _fresh()
    s = jfleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": hybrid.get("dp", 1), "mp_degree": 1,
                        "sharding_degree": hybrid.get("sharding", 1),
                        "pp_degree": 1}
    jfleet.init(is_collective=True, strategy=s)
    paddle.seed(7)
    model = JaxGPT(jax_gpt_config("tiny", hidden_dropout_prob=0.0,
                                  attention_dropout_prob=0.0))
    weights = {k: np.asarray(v._data) for k, v in model.state_dict().items()}
    optimizer = jopt.AdamW(learning_rate=workers.LR,
                           parameters=model.parameters())
    step = jax_train_step(model, model.loss_fn, optimizer)
    ids, labels = workers.global_batch()
    losses = [float(step(ids, labels)) for _ in range(workers.STEPS)]
    params = {n: np.asarray(p._data) for n, p in model.named_parameters()}
    _fresh()
    return weights, losses, params


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("data_parallel")
    weights, dp_losses, dp_params = _jax_run(dp=8)
    np.savez(out / "weights.npz", **weights)
    proc = launch("train", out, out / "logs", str(out / "weights.npz"))
    try:
        w2, sh_losses, sh_params = _jax_run(dp=2, sharding=4)
    except BaseException:
        proc.kill()
        proc.communicate()
        raise
    arrays, info = wait_ranks(proc, out, out / "logs")
    for k in weights:
        np.testing.assert_array_equal(w2[k], weights[k])   # one init
    want = {m: (dp_losses, dp_params) for m in MODES}
    want["fleet"] = (sh_losses, sh_params)
    return want, arrays, info


@pytest.mark.parametrize("mode", MODES)
def test_losses_match_jax_fleet(runs, mode):
    want, _, info = runs
    for r in range(N):
        np.testing.assert_allclose(info[r][mode], want[mode][0],
                                   rtol=LOSS_RTOL, err_msg=f"rank {r}")
    assert info[0][mode][-1] < info[0][mode][0]


@pytest.mark.parametrize("mode", MODES)
def test_parameters_match_jax_fleet(runs, mode):
    want, arrays, _ = runs
    params = want[mode][1]
    for name, ref in params.items():
        np.testing.assert_allclose(arrays[0][f"{mode}/{name}"], ref,
                                   rtol=0, atol=PARAM_ATOL, err_msg=name)


@pytest.mark.parametrize("mode", MODES)
def test_ranks_hold_identical_parameters(runs, mode):
    _, arrays, _ = runs
    keys = [k for k in arrays[0] if k.startswith(mode + "/")]
    assert keys
    for r in range(1, N):
        for k in keys:
            np.testing.assert_array_equal(arrays[r][k], arrays[0][k],
                                          err_msg=f"{k} on rank {r}")


@pytest.mark.parametrize("level", ["os", "os_g"])
def test_sharded_state_is_each_ranks_quarter(runs, level):
    """Each rank holds moments for a quarter of the bucket elements, and
    the gathered ``state_dict`` equals DataParallel's moments."""
    _, _, info = runs
    for r in range(N):
        assert info[r][f"{level}_shard_elems"] * N == \
            info[r][f"{level}_bucket_elems"]
        assert info[r][f"{level}_moment1_err"] <= 1e-6
        assert info[r][f"{level}_reload_err"] == 0.0
    assert info[0]["dp_buckets"] > 1        # several buckets, in order


def test_no_sync_then_fused_allreduce_equals_the_synced_gradients(runs):
    _, _, info = runs
    for r in range(N):
        assert info[r]["no_sync_err"] <= 1e-6
        assert info[r]["broadcast_dp_equal"]


def test_fleet_groups(runs):
    _, _, info = runs
    for r in range(N):
        g = info[r]["fleet_groups"]
        assert g["dp"] == [r % 2, r % 2 + 2]
        assert g["sharding"] == [r // 2 * 2, r // 2 * 2 + 1]
        assert g["dp_sharding"] == list(range(N))
        assert g["mode"] == "SHARDING_PARALLEL" and g["sharded"]


def test_communicate_topology_matches_jax():
    from paddle_tpu.distributed.fleet.base.topology import (
        CommunicateTopology as JaxTopology)
    names = ["data", "pipe", "sharding", "sep", "model"]
    dims = [2, 1, 2, 1, 2]
    t, j = CommunicateTopology(names, dims), JaxTopology(names, dims)
    for axis in names:
        assert t.get_comm_list(axis) == j.get_comm_list(axis)
    for rank in range(8):
        assert t.get_coord(rank) == j.get_coord(rank)
        assert t.get_fused_ranks(["data", "sharding"], rank) == \
            j.get_fused_ranks(["data", "sharding"], rank)


@pytest.mark.parametrize("degree", ["mp_degree", "pp_degree", "sep_degree",
                                    "cp_degree", "ep_degree"])
def test_fleet_degrees_of_later_slices_raise(degree):
    """Model, sep, cp, pipeline and expert parallelism run
    (tests/test_torch_tensor_parallel.py, test_torch_segment_parallel.py,
    test_torch_pipeline_parallel.py and test_torch_expert_parallel.py
    build their groups on 4 ranks): in a world of one, a degree of 2 is
    refused only for its rank count."""
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 1, degree: 2}
    try:
        with pytest.raises(ValueError,
                           match="the topology has 2 ranks, the world 1"):
            fleet.init(is_collective=True, strategy=s, device="cpu")
    finally:
        tdist.destroy_process_group()


def test_fleet_init_at_world_size_one():
    """``dp_degree=-1`` absorbs the ranks (one here); distributed_model
    leaves a one-rank model unwrapped, as the reference does."""
    import torch
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": -1}
    try:
        fleet.init(is_collective=True, strategy=s, device="cpu")
        hcg = fleet.get_hybrid_communicate_group()
        assert hcg.get_data_parallel_world_size() == 1
        assert hcg.get_parallel_mode() == "DATA_PARALLEL"
        assert tdist.get_backend() == "gloo"
        model = torch.nn.Linear(2, 2)
        assert fleet.distributed_model(model) is model
        assert fleet.worker_num() == 1 and fleet.is_first_worker()
    finally:
        tdist.destroy_process_group()
    assert not tdist.is_initialized()


# a rank that counts its attempts in OUT/attempt.<rank> and exits 1: in
# mode "once" rank 1 on its first attempt only, in mode "always" every time
RESTART_SCRIPT = """\
import os, sys
mode, out = sys.argv[1], sys.argv[2]
rank = os.environ["PADDLE_TRAINER_ID"]
marker = os.path.join(out, "attempt." + rank)
first = not os.path.exists(marker)
with open(marker, "a") as f:
    f.write("x")
if mode == "always" or (first and rank == "1"):
    sys.exit(1)
"""


def _restart_script(tmp_path):
    path = tmp_path / "rank.py"
    path.write_text(RESTART_SCRIPT)
    return path


def test_launcher_restarts_a_failed_rank(tmp_path):
    """Rank 1 exits 1 on the first attempt: the launcher stops the
    group, starts it again, and exits 0."""
    proc = launch("once", tmp_path, tmp_path / "logs", max_restart=1,
                  script=_restart_script(tmp_path))
    text, _ = proc.communicate(timeout=120)
    assert proc.returncode == 0, text
    for r in range(N):
        attempts = len(open(tmp_path / f"attempt.{r}").read())
        assert attempts == 2 if r == 1 else attempts in (1, 2)
    assert "rank 1 exited with 1" in text


def test_launcher_gives_up_after_max_restart(tmp_path):
    proc = launch("always", tmp_path, tmp_path / "logs", max_restart=1,
                  script=_restart_script(tmp_path))
    text, _ = proc.communicate(timeout=120)
    assert proc.returncode == 1, text
    assert "giving up after 1 restarts" in text
    for r in range(N):               # two attempts started every rank
        log = open(tmp_path / "logs" / f"workerlog.{r}").read()
        assert "=== attempt 0" in log and "=== attempt 1" in log
        assert "=== attempt 2" not in log


def test_spawn_starts_gloo_ranks(tmp_path):
    proc = subprocess.run(
        [sys.executable, workers.__file__, "spawn", str(tmp_path)],
        env=dict(os.environ, PYTHONPATH=os.path.dirname(
            os.path.dirname(workers.__file__))),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    got = [json.load(open(tmp_path / f"spawn{r}.json")) for r in range(2)]
    assert got == [{"rank": r, "world": 2, "sum": 1.0} for r in range(2)]


def test_device_rule_without_a_card():
    """The entry points run on the card unless the caller asks for the
    CPU: without one they raise."""
    import torch
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdist.init_parallel_env()
    with pytest.raises(RuntimeError, match="no CUDA"):
        tlaunch("script.py", devices="0")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tdist.spawn(print)
    assert not tdist.is_initialized()


@pytest.mark.parametrize("mode", ["dp", "os", "os_g"])
def test_world_of_one_is_bit_equal_to_the_plain_step(mode):
    """At one rank a reduction is a copy and K3's plain version rounds
    each element alike over a flat bucket shard as over a parameter, so
    DataParallel and both ZeRO stages equal the plain O2 ``train_step``
    bit for bit (the card's phase 17 holds the same at one H100)."""
    import torch
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.jit import train_step
    from paddle_tpu_torch.models import GPTForPretraining, gpt_config

    def o2(m, ids, labels):
        with amp.auto_cast(enable=True, level="O2", dtype="bfloat16"):
            return m.loss_fn(m(ids), labels)

    def run(wrap):
        model = GPTForPretraining(gpt_config(
            "tiny", hidden_dropout_prob=0.0, attention_dropout_prob=0.0),
            device="cpu", seed=3)
        opt = optimizer.AdamW(learning_rate=1e-3,
                              parameters=model.parameters(),
                              multi_precision=True)
        model, opt = amp.decorate(models=model, optimizers=opt, level="O2",
                                  dtype="bfloat16")
        model, opt = wrap(model, opt)
        step = train_step(model, None, opt, step_fn=o2)
        ids, labels = workers.global_batch()
        losses = [float(step(ids[:2], labels[:2])) for _ in range(3)]
        inner = getattr(model, "_layers", model)
        return losses, {n: p.detach().clone()
                        for n, p in inner.named_parameters()}

    wraps = {"dp": lambda m, o: (tdist.DataParallel(m), o),
             "os": lambda m, o: group_sharded_parallel(m, o, "os")[:2],
             "os_g": lambda m, o: group_sharded_parallel(m, o, "os_g")[:2]}
    want_losses, want = run(lambda m, o: (m, o))
    try:
        tdist.init_parallel_env(device="cpu")
        losses, got = run(wraps[mode])
    finally:
        tdist.destroy_process_group()
    assert losses == want_losses
    for n, p in want.items():
        assert torch.equal(got[n], p), n


@pytest.mark.parametrize("level", ["os", "os_g", "p_g_os"])
def test_sharding_clips_by_the_global_norm(level):
    """In a world of one each stage's sharded update clips by the norm
    of its gradient shards, scaled into each bucket before K3, under a
    ``GradScaler``: 3 fp32 steps of the unsharded optimizer with the
    same clip (an active one, 0.5) give the same losses and norms within
    rtol 1e-6 (the same squares summed by bucket, not by tensor) and
    parameters within 1e-5 (Adam's normalised update turns a last-bit
    gradient difference into ~1e-6 of a weight per step)."""
    import torch
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.jit import train_step
    from paddle_tpu_torch.models import GPTForPretraining, gpt_config
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm

    def run(wrap):
        model = GPTForPretraining(gpt_config(
            "tiny", hidden_dropout_prob=0.0, attention_dropout_prob=0.0),
            device="cpu", seed=3)
        clip = ClipGradByGlobalNorm(0.5)
        opt = optimizer.AdamW(learning_rate=1e-3,
                              parameters=model.parameters(), grad_clip=clip)
        model, opt = wrap(model, opt)
        scaler = amp.GradScaler(init_loss_scaling=2.0 ** 10)
        step = train_step(model, None, opt, scaler=scaler,
                          step_fn=workers._step_fn)
        ids, labels = workers.global_batch()
        losses, norms = [], []
        for _ in range(3):
            losses.append(float(step(ids[:2], labels[:2])))
            norms.append(float(clip.last_norm))
        return losses, norms, {n: v.detach().clone()
                               for n, v in model.state_dict().items()}

    want_losses, want_norms, want = run(lambda m, o: (m, o))
    assert min(want_norms) > 0.5                   # the clip is active
    try:
        tdist.init_parallel_env(device="cpu")
        losses, norms, got = run(
            lambda m, o: group_sharded_parallel(m, o, level)[:2])
    finally:
        tdist.destroy_process_group()
    np.testing.assert_allclose(losses, want_losses, rtol=1e-6)
    np.testing.assert_allclose(norms, want_norms, rtol=1e-6)
    for n, p in want.items():
        key = n if n in got else f"_layers.{n}"
        np.testing.assert_allclose(got[key].numpy(), p.numpy(), rtol=0,
                                   atol=1e-5, err_msg=n)


@pytest.mark.parametrize("level", ["os_g", "p_g_os"])
def test_sharding_refuses_a_per_tensor_norm_clip(level):
    """``ClipGradByNorm`` is a norm a tensor: under stages 2 and 3 a rank
    holds its gradient shard, not a whole gradient, so it raises."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.models import GPTForPretraining, gpt_config
    from paddle_tpu_torch.nn import ClipGradByNorm
    model = GPTForPretraining(gpt_config("tiny"), device="cpu", seed=3)
    opt = optimizer.AdamW(learning_rate=1e-3, parameters=model.parameters(),
                          grad_clip=ClipGradByNorm(1.0))
    try:
        tdist.init_parallel_env(device="cpu")
        with pytest.raises(NotImplementedError, match="ClipGradByNorm"):
            group_sharded_parallel(model, opt, level)
    finally:
        tdist.destroy_process_group()


def test_gradient_merge_steps_on_the_window_mean():
    """``GradientMergeOptimizer(k_steps=2)``: the first step only
    accumulates; the second updates once with the two gradients'
    mean, as one AdamW step on the mean loss does."""
    import torch
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed.passes import GradientMergeOptimizer
    rs = np.random.RandomState(5)
    w0 = rs.randn(4, 3).astype(np.float32)
    xa, xb = (torch.tensor(rs.randn(6, 4).astype(np.float32))
              for _ in range(2))

    def model():
        p = torch.nn.Parameter(torch.tensor(w0))
        return p, optimizer.AdamW(learning_rate=0.1, parameters=[p])

    p, opt = model()
    merged = GradientMergeOptimizer(opt, k_steps=2, avg=True)
    for x in (xa, xb):
        (x @ p).square().sum().backward()
        merged.step()
        merged.clear_grad()
        if x is xa:
            assert torch.equal(p.detach(), torch.tensor(w0))
            assert p.grad is not None             # kept for the window
    q, ref = model()
    (((xa @ q).square().sum() + (xb @ q).square().sum()) / 2).backward()
    ref.step()
    torch.testing.assert_close(p.detach(), q.detach(), rtol=1e-6, atol=1e-6)



KNOB_PASSES = [("auto_parallel_amp", {"init_loss_scaling": 1024.0}),
               ("auto_parallel_fp16", {}),
               ("auto_parallel_recompute", {"checkpoints": ["gpt.layers.0"]}),
               ("auto_parallel_sharding", {"stage": 2, "degree": 4}),
               ("auto_parallel_gradient_merge_pass", {"k_steps": 4,
                                                      "avg": False}),
               ("pipeline_scheduler_1F1B", {}), ("fuse_all_reduce", {}),
               ("fused_attention", {}), ("fused_feedforward", {})]


@pytest.mark.parametrize("name,attrs", KNOB_PASSES,
                         ids=[n for n, _ in KNOB_PASSES])
def test_strategy_passes_set_the_knobs_the_reference_sets(name, attrs):
    from paddle_tpu.distributed import passes as jpasses
    from paddle_tpu_torch.distributed import passes as tpasses
    seen = []
    for fleet_mod, passes in ((jfleet, jpasses), (fleet, tpasses)):
        s = fleet_mod.DistributedStrategy()
        ctx = passes.PassContext(strategy=s)
        passes.new_pass(name, attrs).apply([None], [None], ctx)
        seen.append((ctx.attrs, [(k, dict(getattr(s, k + "_configs")),
                                  getattr(s, k))
                                 for k in ("amp", "recompute", "sharding",
                                           "gradient_merge", "pipeline")]))
    assert seen[0] == seen[1]
