"""The port's ZeRO stage 3 (``group_sharded_parallel(level="p_g_os")``,
``GroupShardedStage3``) across 4 gloo ranks against the JAX package's
stage-3 runs, and at a world of one against the plain step.

One 4-rank group (``tests/torch_dist_workers.py stage3``, started by the
port's launcher with ``--device cpu``) trains three models for 3 steps
on ``tests/test_fleet_engine.py``'s stage-3 batch (8 x 32, AdamW lr
1e-3): the tiny GPT (its head tied to the word embedding) on each
rank's own 2 rows; the tiny GPT with ``use_recompute=True`` and the tiny
LLaMA (GQA 4/2) with ``use_recompute=True`` on the global batch through
``TrainStep(mesh=dp 2 x sharding 2)``.  The weights are carried from
the JAX models, and the JAX references run
``group_sharded_parallel(level="p_g_os")`` under ``fleet.init`` at dp 2
x sharding 4, ``test_group_sharded_stage3``'s setting: on one controller
the mesh shards the same global batch, so every run computes the same
global-mean loss.

Tolerances: losses ``rtol = 2e-4`` and parameters after 3 steps ``atol
= 1e-4``, as ``test_torch_data_parallel.py`` holds stages 1 and 2 (fp32
in another summation order).  Across ranks the gathered weights are
bit-identical; at a world of one every stage-3 run equals the plain
O2 step bit for bit.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.communication.group import _reset_groups
from paddle_tpu.distributed.fleet.base.topology import _clear_hcg
from paddle_tpu.distributed.fleet.meta_parallel.sharding import (
    group_sharded_parallel as jax_group_sharded_parallel)
from paddle_tpu.distributed.mesh import reset_mesh
from paddle_tpu.jit import train_step as jax_train_step
from paddle_tpu.models import GPTForPretraining as JaxGPT
from paddle_tpu.models import gpt_config as jax_gpt_config
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_config as jax_llama_config

import paddle_tpu_torch.distributed as tdist

import torch_dist_workers as workers
from torch_dist_workers import launch, wait_ranks

N = workers.N_RANKS
RUNS = list(workers.STAGE3_RUNS)
LOSS_RTOL = 2e-4
PARAM_ATOL = 1e-4
ALIGN = 64                      # 256-byte slots of fp32 elements


def _fresh():
    reset_mesh()
    _reset_groups()
    _clear_hcg()


def _jax_model(kind, rc):
    paddle.seed(7)
    if kind == "gpt":
        return JaxGPT(jax_gpt_config("tiny", hidden_dropout_prob=0.0,
                                     attention_dropout_prob=0.0,
                                     use_recompute=rc))
    return JaxLlama(jax_llama_config("tiny", use_recompute=rc))


def _weights(model):
    return {k: np.asarray(v._data) for k, v in model.state_dict().items()}


def _jax_stage3(kind, rc):
    """The JAX package's stage-3 run at dp 2 x sharding 4: its initial
    weights, losses and final parameters."""
    _fresh()
    s = jfleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 2, "mp_degree": 1,
                        "sharding_degree": 4, "pp_degree": 1}
    jfleet.init(is_collective=True, strategy=s)
    model = _jax_model(kind, rc)
    weights = _weights(model)
    optimizer = jopt.AdamW(learning_rate=workers.LR,
                           parameters=model.parameters())
    jax_group_sharded_parallel(model, optimizer, level="p_g_os")
    step = jax_train_step(model, model.loss_fn, optimizer)
    ids, labels = workers.stage3_batch(model.config.vocab_size)
    losses = [float(step(ids, labels)) for _ in range(workers.STEPS)]
    params = {n: np.asarray(p._data) for n, p in model.named_parameters()}
    _fresh()
    return weights, losses, params


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("zero3")
    np.savez(out / "gpt.npz", **_weights(_jax_model("gpt", False)))
    np.savez(out / "llama.npz", **_weights(_jax_model("llama", True)))
    proc = launch("stage3", out, out / "logs", str(out / "gpt.npz"),
                  str(out / "llama.npz"))
    try:
        want = {}
        for tag, (kind, rc, _) in workers.STAGE3_RUNS.items():
            weights, losses, params = _jax_stage3(kind, rc)
            carried = dict(np.load(out / f"{kind}.npz"))
            for k in carried:                          # one init
                np.testing.assert_array_equal(weights[k], carried[k])
            want[tag] = (losses, params)
    except BaseException:
        proc.kill()
        proc.communicate()
        raise
    arrays, info = wait_ranks(proc, out, out / "logs")
    return want, arrays, info


@pytest.mark.parametrize("tag", RUNS)
def test_stage3_losses_match_jax(runs, tag):
    want, _, info = runs
    for r in range(N):
        np.testing.assert_allclose(info[r][tag], want[tag][0],
                                   rtol=LOSS_RTOL, err_msg=f"rank {r}")
    assert info[0][tag][-1] < info[0][tag][0]


@pytest.mark.parametrize("tag", RUNS)
def test_stage3_parameters_match_jax(runs, tag):
    want, arrays, _ = runs
    for name, ref in want[tag][1].items():
        np.testing.assert_allclose(arrays[0][f"{tag}/{name}"], ref, rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)


@pytest.mark.parametrize("tag", RUNS)
def test_stage3_ranks_gather_identical_parameters(runs, tag):
    _, arrays, _ = runs
    keys = [k for k in arrays[0] if k.split("/")[0] in
            (tag, f"{tag}_moment1")]
    assert keys
    for r in range(1, N):
        for k in keys:
            np.testing.assert_array_equal(arrays[r][k], arrays[0][k],
                                          err_msg=f"{k} on rank {r}")


@pytest.mark.parametrize("tag", RUNS)
def test_stage3_each_rank_holds_a_quarter(runs, tag):
    """Between steps every parameter is empty, and each rank holds a
    quarter of each segment flat's values, averaged gradient and
    optimizer moments; the flats pad each slot to 256 bytes and each
    flat to 4 aligned units at most."""
    _, _, info = runs
    for r in range(N):
        lay = info[r][f"{tag}_layout"]
        assert lay["held"] == 0
        for key in ("shard_elems", "grad_elems", "moment_elems"):
            assert lay[key] * N == lay["flat_elems"], key
        pad = lay["flat_elems"] - lay["param_elems"]
        assert 0 <= pad < (lay["n_params"] + lay["flats"] * N) * ALIGN


@pytest.mark.parametrize("tag", RUNS)
def test_stage3_segments_and_collectives_per_step(runs, tag):
    """The root (embeddings, final norm, head; GPT's head tied to the
    word embedding) and one segment a layer; a step gathers the root
    once and each layer twice (forward, backward: recompute's second
    forward gathers nothing more) and reduce-scatters every flat once."""
    _, _, info = runs
    lay = info[0][f"{tag}_layout"]
    prefix = "gpt" if tag.startswith("gpt") else "llama"
    assert lay["segments"] == ["root", f"{prefix}.layers.0",
                               f"{prefix}.layers.1"]
    root_flats = lay["flats"] - lay["layer_flats"]
    want = [root_flats + 2 * lay["layer_flats"], lay["flats"]]
    assert lay["moved"] == [want] * workers.STEPS
    assert lay["tied"] == (prefix == "gpt")


def test_stage3_state_dict_and_save_round_trip(runs):
    """``state_dict`` and ``get_all_parameters`` give the full weights on
    every rank; ``save_group_sharded_model`` writes them and the gathered
    optimizer state, which load into a fresh stage-3 model and sharded
    optimizer exactly."""
    _, _, info = runs
    for r in range(N):
        assert info[r]["gpt_get_all_equal"]
        assert info[r]["save_roundtrip"] and info[r]["saved_opt"]
        assert info[r]["opt_reload_err"] == 0.0
        for tag in RUNS:          # the gathered state has full shapes
            assert info[r][f"{tag}_moment_shapes_ok"]


def _o2(m, ids, labels):
    from paddle_tpu_torch import amp
    with amp.auto_cast(enable=True, level="O2", dtype="bfloat16"):
        return m.loss_fn(m(ids), labels)


def _o2_run(kind, rc, wrap=None, decorate_after=False, steps=3):
    """Three O2 steps of the tiny model (``wrap`` applied after
    ``amp.decorate``, or before it with ``decorate_after``): the losses,
    the full weights, and each step's collectives when wrapped."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.jit import train_step
    from paddle_tpu_torch.models import (GPTForPretraining,
                                         LlamaForCausalLM, gpt_config,
                                         llama_config)
    if kind == "gpt":
        model = GPTForPretraining(gpt_config(
            "tiny", hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
            use_recompute=rc), device="cpu", seed=3)
    else:
        model = LlamaForCausalLM(llama_config("tiny", use_recompute=rc),
                                 device="cpu", seed=3)
    opt = optimizer.AdamW(learning_rate=1e-3, parameters=model.parameters(),
                          multi_precision=True)
    if wrap is not None and decorate_after:
        model, opt = wrap(model, opt)
    model, opt = amp.decorate(models=model, optimizers=opt, level="O2",
                              dtype="bfloat16")
    if wrap is not None and not decorate_after:
        model, opt = wrap(model, opt)
    step = train_step(model, None, opt, step_fn=_o2)
    ids, labels = workers.stage3_batch(model.config.vocab_size)
    red = getattr(model, "_reducer", None)
    losses, moved = [], []
    for _ in range(steps):
        before = (red.gathers, red.reduce_scatters) if red else None
        losses.append(float(step(ids[:2], labels[:2])))
        if red:
            moved.append((red.gathers - before[0],
                          red.reduce_scatters - before[1]))
    return losses, model.state_dict(), moved, red


@pytest.mark.parametrize("kind,rc", [("gpt", False), ("gpt", True),
                                     ("llama", False), ("llama", True)])
def test_world_of_one_stage3_is_bit_equal_to_the_plain_step(kind, rc):
    """At one rank a gather and a reduce-scatter are copies, the gathered
    parameters start on 256-byte boundaries, and K3's plain version
    rounds each element alike over a flat shard as over a parameter, so
    stage 3, with recompute or without, equals the plain O2 step (no
    recompute) bit for bit in its losses and weights, with an exact count
    of collectives a step.  Recompute alone equals it too."""
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    want_losses, want, _, _ = _o2_run(kind, False)
    if rc:
        losses, got, _, _ = _o2_run(kind, True)
        assert losses == want_losses
        for n, v in want.items():
            assert torch.equal(got[n], v), n
    try:
        tdist.init_parallel_env(device="cpu")
        losses, got, moved, red = _o2_run(
            kind, rc, lambda m, o: group_sharded_parallel(m, o, "p_g_os")[:2])
    finally:
        tdist.destroy_process_group()
    assert losses == want_losses
    for n, v in want.items():
        assert torch.equal(got[n], v), n
    # O2: each segment holds a bf16 flat and an fp32 one (the norms)
    assert [len(s.flats) for s in red.segments] == [2, 2, 2]
    assert moved == [(2 + 2 * 4, 6)] * 3


def test_decorate_after_wrapping_casts_the_shards():
    """``amp.decorate`` after ``group_sharded_parallel`` casts the empty
    parameters; the next forward casts the shards with them, so the run
    equals decorating first."""
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel

    def wrap(m, o):
        return group_sharded_parallel(m, o, "p_g_os")[:2]

    try:
        tdist.init_parallel_env(device="cpu")
        first = _o2_run("gpt", False, wrap)
        after = _o2_run("gpt", False, wrap, decorate_after=True)
    finally:
        tdist.destroy_process_group()
    assert after[0] == first[0]
    for n, v in first[1].items():
        assert after[1][n].dtype == v.dtype and torch.equal(after[1][n], v)
    assert {f.dtype for f in after[3].buckets} == {torch.bfloat16,
                                                  torch.float32}


def test_stage3_parameters_are_empty_between_steps_and_full_in_use():
    """Between steps ``parameters()`` are empty tensors of their dtype;
    ``get_all_parameters`` fills them (every rank calls it), the next
    step frees them again, and ``state_dict`` leaves them empty."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed.sharding import GroupShardedStage3
    from paddle_tpu_torch.distributed.fleet import DygraphShardingOptimizer
    from paddle_tpu_torch.jit import train_step
    from paddle_tpu_torch.models import GPTForPretraining, gpt_config
    try:
        tdist.init_parallel_env(device="cpu")
        bare = GPTForPretraining(gpt_config("tiny"), device="cpu", seed=1)
        shapes = {n: p.shape for n, p in bare.named_parameters()}
        model = GroupShardedStage3(bare, device="cpu")
        opt = DygraphShardingOptimizer.over(
            optimizer.AdamW(parameters=model.parameters()), model._group)
        assert all(p.numel() == 0 for p in model.parameters())
        full = model.get_all_parameters()
        assert [p.shape for p in full] == list(shapes.values())
        step = train_step(model, None, opt, step_fn=workers._step_fn)
        ids, labels = workers.stage3_batch(512)
        step(ids[:2], labels[:2])
        assert all(p.numel() == 0 and p.grad is None
                   for p in model.parameters())
        sd = model.state_dict()
        assert {n: v.shape for n, v in sd.items()} == shapes
        assert all(p.numel() == 0 for p in model.parameters())
        host = model.get_all_parameters(convert2cpu=True)
        assert all(torch.equal(h, sd[n]) for h, n in zip(host, shapes))
        assert all(p.numel() == 0 for p in model.parameters())
    finally:
        tdist.destroy_process_group()


@pytest.mark.parametrize("level", ["dp", "os", "os_g", "p_g_os"])
def test_a_deleted_wrapped_model_frees_its_reducer(level):
    """A parameter keeps its gradient hook on its C++ side, out of the
    garbage collector's sight: the hook holds its reducer weakly, so a
    wrapped model, once deleted after a backward, frees its reducer and
    the reducer's flat buffers (on the card, gigabytes that a later run
    would otherwise find still allocated)."""
    import gc
    import weakref
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.models import GPTForPretraining, gpt_config
    try:
        tdist.init_parallel_env(device="cpu")
        model = GPTForPretraining(gpt_config("tiny"), device="cpu")
        opt = optimizer.AdamW(parameters=model.parameters())
        if level == "dp":
            model = tdist.DataParallel(model)
        else:
            model, opt, _ = group_sharded_parallel(model, opt, level)
        ref = weakref.ref(model._reducer)
        model.train()
        ids, labels = workers.stage3_batch(512)
        workers._step_fn(model, torch.tensor(ids[:2]),
                         torch.tensor(labels[:2])).backward()
        opt.step()
        del model, opt
        gc.collect()
        assert ref() is None
    finally:
        tdist.destroy_process_group()


def test_stage3_accumulates_a_second_backward_before_the_step():
    """Two backwards before one step (micro-batches): the second
    reduce-scattered gradient is added to the first in the shard, as
    ``.grad`` accumulates on the plain model (fp32, a world of one: bit
    for bit)."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.models import GPTForPretraining, gpt_config
    ids, labels = (torch.tensor(a) for a in workers.stage3_batch(512))

    def run(wrap):
        model = GPTForPretraining(gpt_config(
            "tiny", hidden_dropout_prob=0.0, attention_dropout_prob=0.0),
            device="cpu", seed=5)
        opt = optimizer.AdamW(learning_rate=1e-3,
                              parameters=model.parameters())
        model, opt = wrap(model, opt)
        model.train()
        for j in range(2):
            rows = slice(2 * j, 2 * j + 2)
            (workers._step_fn(model, ids[rows], labels[rows]) / 2) \
                .backward()
        opt.step()
        opt.clear_grad()
        return model.state_dict()

    want = run(lambda m, o: (m, o))
    try:
        tdist.init_parallel_env(device="cpu")
        got = run(lambda m, o: group_sharded_parallel(m, o, "p_g_os")[:2])
    finally:
        tdist.destroy_process_group()
    for n, v in want.items():
        assert torch.equal(got[n], v), n
