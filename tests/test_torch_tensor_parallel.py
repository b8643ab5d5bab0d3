"""The port's tensor parallelism (mp), Megatron sequence parallelism (SP)
and hybrid dp x sharding x mp across 4 gloo ranks, against the JAX
package's runs of ``tests/test_fleet_engine.py``.

One 4-rank group (``tests/torch_dist_workers.py tensor_parallel``,
started by the port's launcher with ``--device cpu``) trains the tiny
GPT (tied head) and a tiny GQA LLaMA (8 heads over 4 kv heads, so mp 4
splits neither) for 3 steps on ``_run_losses``'s global batch (8 x 32,
AdamW lr 1e-3) under ``fleet.init`` at mp 4, dp 2 x mp 2, mp 4 + SP and
sharding 2 x mp 2 (ZeRO stage 1 over the sharding group), each through
``fleet.distributed_model`` (``TensorParallel``),
``fleet.distributed_optimizer`` and ``TrainStep(mesh=...)``.  The
weights are the JAX models' (seed 7 and 11), carried through ``.npz``
files and sliced to each rank's shards; the JAX references run
``_run_losses``'s settings on 8 virtual devices: dp 2 x mp 4 (the port's
mp 4 and dp 2 x mp 2 runs: every layout computes the same global mean),
dp 2 x mp 4 with SP, and dp 2 x sharding 2 x mp 2.  The ranks also hold
the mp layers and ``ParallelCrossEntropy`` on the test's inputs (against
the JAX layers at mp 4), the SP gradient hooks, the RNG streams and
``TensorParallel``'s broadcasts.

Tolerances: losses ``rtol = 2e-4`` (``test_fleet_engine.py``'s) and
parameters after 3 steps ``atol = 1e-4`` (``test_torch_zero3.py``'s):
fp32 in another summation order.  The mp layers: ``atol = 1e-5`` (fp32,
a sum over 4 partial products).  The SP hooks: the hooked norm gradients
within ``1e-5`` of the model without SP, the unhooked ones off by more
than a tenth of the largest gradient.
"""
import types

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.communication.group import _reset_groups
from paddle_tpu.distributed.fleet.base.topology import (
    CommunicateTopology as JaxTopology, _clear_hcg)
from paddle_tpu.distributed.fleet.meta_parallel.parallel_layers import (
    mp_layers as jmp)
from paddle_tpu.distributed.mesh import reset_mesh
from paddle_tpu.jit import train_step as jax_train_step
from paddle_tpu.models import GPTForPretraining as JaxGPT
from paddle_tpu.models import gpt_config as jax_gpt_config
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama

import paddle_tpu_torch.distributed as tdist
from paddle_tpu_torch import optimizer
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.fleet.base.topology import (
    CommunicateTopology, _clear_hcg as _clear_torch_hcg)
from paddle_tpu_torch.distributed.fleet.meta_parallel import TensorParallel
from paddle_tpu_torch.distributed.fleet.meta_parallel.parallel_layers \
    import mp_layers
from paddle_tpu_torch.jit import train_step
from paddle_tpu_torch.models import GPTForPretraining, gpt_config

import torch_dist_workers as workers
from torch_dist_workers import launch, wait_ranks

N = workers.N_RANKS
RUNS = list(workers.TP_RUNS)
LOSS_RTOL = 2e-4
PARAM_ATOL = 1e-4
LAYER_ATOL = 1e-5
SEEDS = {"gpt": 7, "llama": 11}
# the port's run -> the JAX run's hybrid degrees (and SP)
JAX_OF = {"mp4": (dict(dp_degree=2, mp_degree=4), False),
          "dp2_mp2": (dict(dp_degree=2, mp_degree=4), False),
          "mp4_sp": (dict(dp_degree=2, mp_degree=4), True),
          "sh2_mp2": (dict(dp_degree=2, sharding_degree=2, mp_degree=2),
                      False)}


def _fresh():
    reset_mesh()
    _reset_groups()
    _clear_hcg()


def _jax_model(kind, sp=False):
    paddle.seed(SEEDS[kind])
    if kind == "gpt":
        return JaxGPT(jax_gpt_config("tiny", hidden_dropout_prob=0.0,
                                     attention_dropout_prob=0.0,
                                     sequence_parallel=sp))
    return JaxLlama(JaxLlamaConfig(**workers.TP_LLAMA, sequence_parallel=sp))


def _weights(model):
    return {k: np.asarray(v._data) for k, v in model.state_dict().items()}


def _jax_fleet(degrees):
    _fresh()
    s = jfleet.DistributedStrategy()
    s.hybrid_configs = dict(degrees)
    jfleet.init(is_collective=True, strategy=s)


def _jax_run(kind, degrees, sp):
    """``_run_losses`` of the JAX package at ``degrees``: its initial
    weights, 3 losses and final parameters."""
    _jax_fleet(degrees)
    model = _jax_model(kind, sp)
    weights = _weights(model)
    opt = jopt.AdamW(learning_rate=workers.LR, parameters=model.parameters())
    step = jax_train_step(model, model.loss_fn, opt)
    batch = workers.tp_batch(model.config.vocab_size)
    losses = [float(step(*batch)) for _ in range(workers.STEPS)]
    params = {n: np.asarray(p._data) for n, p in model.named_parameters()}
    _fresh()
    return weights, losses, params


def layer_inputs():
    """The mp layers' inputs and weights (divisible by 4), and the
    output gradients each output is weighted by."""
    rs = np.random.RandomState(5)

    def f(*shape):
        return rs.randn(*shape).astype(np.float32)
    return dict(x=f(6, 16), ids=rs.randint(0, 32, (6,)), emb_w=f(32, 16),
                col_w=f(16, 24), col_b=f(24), row_w=f(24, 16), row_b=f(16),
                logits=f(6, 32), labels=np.array([0, 5, 31, -100, 17, 9]),
                ge=f(6, 16), gz=f(6, 16), gl=f(6))


def _jax_layers(li):
    """The JAX package's mp layers at dp 2 x mp 4 on the same inputs:
    every output and gradient the ranks compute."""
    _jax_fleet(dict(dp_degree=2, mp_degree=4))
    t = paddle.to_tensor
    emb = jmp.VocabParallelEmbedding(*li["emb_w"].shape)
    col = jmp.ColumnParallelLinear(*li["col_w"].shape, gather_output=True)
    row = jmp.RowParallelLinear(*li["row_w"].shape, input_is_parallel=False)
    ce = jmp.ParallelCrossEntropy()
    for p, key in ((emb.weight, "emb_w"), (col.weight, "col_w"),
                   (col.bias, "col_b"), (row.weight, "row_w"),
                   (row.bias, "row_b")):
        p.set_value(t(li[key]))
    x = t(li["x"], stop_gradient=False)
    logits = t(li["logits"], stop_gradient=False)
    e = emb(t(li["ids"]))
    y = col(x)
    z = row(y)
    loss_rows = ce(logits, t(li["labels"]))
    total = (e * t(li["ge"])).sum() + (z * t(li["gz"])).sum() + \
        (loss_rows * t(li["gl"])).sum()
    total.backward()
    out = dict(emb=e, col=y, row=z, ce=loss_rows, col_split=y, dx=x.grad,
               dlogits=logits.grad, demb=emb.weight.grad,
               dcol=col.weight.grad, drow=row.weight.grad,
               drow_b=row.bias.grad)
    out = {k: np.asarray(v._data) for k, v in out.items()}
    _fresh()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("tensor_parallel")
    _fresh()
    weights = {k: _weights(_jax_model(k)) for k in ("gpt", "llama")}
    for k, w in weights.items():
        np.savez(out / f"{k}.npz", **w)
    li = layer_inputs()
    np.savez(out / "layers.npz", **li)
    proc = launch("tensor_parallel", out, out / "logs",
                  str(out / "gpt.npz"), str(out / "llama.npz"),
                  str(out / "layers.npz"), threads=2)
    try:
        want, done = {}, {}
        for tag in RUNS:
            kind, key = tag.split("_", 1)
            degrees, sp = JAX_OF[key]
            cache = (kind, tuple(sorted(degrees.items())), sp)
            if cache not in done:
                done[cache] = _jax_run(kind, degrees, sp)
                for name, a in weights[kind].items():     # one init
                    np.testing.assert_array_equal(done[cache][0][name], a)
            want[tag] = done[cache][1:]
        want["layers"] = _jax_layers(li)
    except BaseException:
        proc.kill()
        proc.communicate()
        raise
    arrays, info = wait_ranks(proc, out, out / "logs")
    return want, arrays, info, weights


@pytest.mark.parametrize("tag", RUNS)
def test_tensor_parallel_losses_match_jax(runs, tag):
    want, _, info, _ = runs
    for r in range(N):
        np.testing.assert_allclose(info[r][tag], want[tag][0],
                                   rtol=LOSS_RTOL, err_msg=f"rank {r}")
    assert info[0][tag][-1] < info[0][tag][0]


@pytest.mark.parametrize("tag", RUNS)
def test_tensor_parallel_parameters_match_jax(runs, tag):
    """The parameters after 3 steps, gathered from the mp shards."""
    want, arrays, _, _ = runs
    for name, ref in want[tag][1].items():
        np.testing.assert_allclose(arrays[0][f"{tag}/{name}"], ref, rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)


@pytest.mark.parametrize("tag", RUNS)
def test_distributed_model_wraps_tensor_parallel_and_splits(runs, tag):
    """``fleet.distributed_model`` returns ``TensorParallel``; the mp
    group is the topology's and each rank holds 1/mp of every split
    parameter and all of the others."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    _, _, info, _ = runs
    kind = tag.split("_", 1)[0]
    mp = 4 if "mp4" in tag else 2
    model = GPTForPretraining(gpt_config("tiny"), device="cpu") \
        if kind == "gpt" else \
        LlamaForCausalLM(LlamaConfig(**workers.TP_LLAMA), device="cpu")
    held = sum(p.numel() // mp if mp_layers.is_split(p) else p.numel()
               for p in model.parameters())
    for r in range(N):
        assert info[r][f"{tag}_wrapped"] == "TensorParallel"
        assert len(info[r][f"{tag}_groups"]["mp"]) == mp
        assert r in info[r][f"{tag}_groups"]["mp"]
        assert info[r][f"{tag}_held"] == held


LAYER_KEYS = ["emb", "col", "col_split", "row", "ce", "dx", "dlogits",
              "demb", "dcol", "drow", "drow_b"]


@pytest.mark.parametrize("key", LAYER_KEYS)
def test_mp_layers_match_jax(runs, key):
    """``VocabParallelEmbedding``, ``ColumnParallelLinear`` (gathered and
    split output), ``RowParallelLinear`` (split input, bias after the
    sum) and ``ParallelCrossEntropy`` (an ignored row among them) at mp 4:
    outputs and gradients against the JAX layers."""
    want, arrays, _, _ = runs
    np.testing.assert_allclose(arrays[0][f"layers/{key}"],
                               want["layers"][key], rtol=0, atol=LAYER_ATOL)


def test_mp_layers_hold_their_shards(runs):
    _, _, info, _ = runs
    assert info[0]["layers_split_shapes"] == dict(emb=[8, 16], col=[16, 6],
                                                  row=[6, 16])


def test_packed_qkv_is_carried_by_heads():
    """GPT's ``[H, 3H]`` qkv weight has contiguous q | k | v thirds: rank
    r's shard holds the columns of its heads in each third, so its q, k
    and v are the full projection's heads of that rank; a contiguous
    ``3H / mp`` slice would not be."""
    h, nh, mp = 64, 4, 4
    hd = h // nh
    rs = np.random.RandomState(0)
    w = torch.tensor(rs.randn(h, 3 * h).astype(np.float32))
    x = torch.tensor(rs.randn(5, h).astype(np.float32))
    full = (x @ w).reshape(5, 3, nh, hd)
    for rank in range(mp):
        shard = mp_layers.shard_of(w, 1, 3, rank, mp)
        mine = (x @ shard).reshape(5, 3, nh // mp, hd)
        assert torch.equal(mine, full[:, :, rank * nh // mp:
                                      (rank + 1) * nh // mp])
        contiguous = (x @ w[:, rank * 3 * h // mp:(rank + 1) * 3 * h // mp]
                      ).reshape(5, 3, nh // mp, hd)
        assert not torch.allclose(contiguous, full[
            :, :, rank * nh // mp:(rank + 1) * nh // mp])
        parts = [mp_layers.shard_of(w, 1, 3, r, mp) for r in range(mp)]
        assert torch.equal(mp_layers.merge_shards(parts, 1, 3), w)


def test_carry_slices_each_rank_its_shards(runs):
    """``load_paddle_tpu_state`` gives rank r of mp 4 the columns of its
    heads in each third of the packed qkv (and of its bias), its rows of
    the vocab-parallel embedding and of LLaMA's head, its columns of fc1
    and its rows of fc2."""
    _, arrays, _, weights = runs
    g, ll = weights["gpt"], weights["llama"]
    for r in range(N):
        a = arrays[r]
        heads = np.concatenate([np.arange(t * 64 + r * 16, t * 64 + r * 16
                                          + 16) for t in range(3)])
        qkv = "gpt.layers.0.attn.qkv_proj"
        np.testing.assert_array_equal(a[f"carry/{qkv}.weight"],
                                      g[f"{qkv}.weight"][:, heads])
        np.testing.assert_array_equal(a[f"carry/{qkv}.bias"],
                                      g[f"{qkv}.bias"][heads])
        emb = "gpt.embeddings.word_embeddings.weight"
        np.testing.assert_array_equal(a[f"carry/{emb}"],
                                      g[emb][r * 128:(r + 1) * 128])
        fc1, fc2 = "gpt.layers.1.mlp.fc1.weight", "gpt.layers.1.mlp.fc2.weight"
        np.testing.assert_array_equal(a[f"carry/{fc1}"],
                                      g[fc1][:, r * 64:(r + 1) * 64])
        np.testing.assert_array_equal(a[f"carry/{fc2}"],
                                      g[fc2][r * 64:(r + 1) * 64])
        np.testing.assert_array_equal(a["carry/lm_head_weight"],
                                      ll["lm_head_weight"][r * 64:
                                                           (r + 1) * 64])


@pytest.mark.parametrize("kind", ["gpt", "llama"])
def test_sequence_parallel_hooks_sum_the_norm_gradients(runs, kind):
    """Under SP each rank's LayerNorm / RMSNorm (and SP bias) gradient
    covers its sequence chunk: the hooks sum it over mp, which gives the
    model without SP's gradients; without the hooks they are off."""
    _, _, info, _ = runs
    i = info[0]
    marked = i[f"sp_hooks_{kind}_marked"]
    assert marked and all("norm" in n or "ln" in n or "bias" in n
                          for n in marked)
    scale = i[f"sp_hooks_{kind}_scale"]
    for r in range(N):
        assert info[r][f"sp_hooks_{kind}_sp_err"] <= 1e-5 * max(scale, 1.0)
        assert info[r][f"sp_hooks_{kind}_sp_unhooked_err"] > 0.1 * scale


def test_rng_tracker_streams(runs):
    """``model_parallel_random_seed``: ``global_seed`` draws the same on
    every mp rank, ``local_seed`` (seed + 1024 + mp rank) differs."""
    _, _, info, _ = runs
    for r in range(N):
        rng = info[r]["rng"]
        assert rng["seeds"] == [1234, 1234 + 1024 + rng["mp_rank"]]
        g, loc = (np.array(rng["draws"][k]) for k in ("global_seed",
                                                      "local_seed"))
        assert all(np.array_equal(g[0], g[j]) for j in range(N))
        assert len({tuple(row) for row in loc}) == N


def test_tensor_parallel_broadcasts_replicated_parameters(runs):
    """Every rank shifted its parameters by its rank; TensorParallel sent
    the mp group's first rank's replicated ones and kept the shards."""
    _, _, info, _ = runs
    for r in range(N):
        b = info[r]["broadcast"]
        assert b["final_ln"] == 1.0
        assert abs(b["qkv_shift"] - r) < 1e-5


def test_unsupported_layouts_raise(runs):
    """GQA with kv heads not divisible by mp, and ZeRO stage 3 of a
    model-parallel model, raise ``NotImplementedError``."""
    _, _, info, _ = runs
    refused = info[0]["refused"]
    assert "kv head" in refused["gqa_kv_heads"]
    assert "model parallelism" in refused["stage3"]


@pytest.mark.parametrize("dims", [dict(data=2, sep=2, model=2),
                                  dict(context=4), dict(data=2, model=2),
                                  dict(sharding=2, model=2)])
def test_communicate_topology_matches_jax(dims):
    """The port's rank grid over the seven axes against the JAX
    package's: every axis's groups, coordinates and fused groups."""
    names = ["data", "pipe", "sharding", "sep", "context", "expert", "model"]
    d = [dims.get(n, 1) for n in names]
    t, j = CommunicateTopology(names, d), JaxTopology(names, d)
    for axis in names:
        assert t.get_comm_list(axis) == j.get_comm_list(axis)
    for rank in range(t.world_size()):
        assert t.get_coord(rank) == j.get_coord(rank)
        for fused in (["data", "sep", "context"], ["sep", "context"],
                      ["data", "sharding"]):
            assert t.get_fused_ranks(fused, rank) == \
                j.get_fused_ranks(fused, rank)


@pytest.mark.parametrize("kind", ["gpt", "llama"])
def test_world_of_one_tensor_parallel_is_bit_equal_to_the_plain_step(kind):
    """A world of one through ``TensorParallel`` and the hybrid
    optimizer: losses and parameters equal to the plain step bit for
    bit."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    def build():
        if kind == "gpt":
            return GPTForPretraining(gpt_config(
                "tiny", hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
                sequence_parallel=True), device="cpu")
        return LlamaForCausalLM(LlamaConfig(**workers.TP_LLAMA,
                                            sequence_parallel=True),
                                device="cpu")
    batch = workers.tp_batch(build().config.vocab_size)
    plain = build()
    step = train_step(plain, None, workers._adamw(plain),
                      step_fn=workers._step_fn)
    want = [float(step(*batch)) for _ in range(workers.STEPS)]
    try:
        s = fleet.DistributedStrategy()
        s.hybrid_configs = {"dp_degree": 1}
        fleet.init(is_collective=True, strategy=s, device="cpu")
        hcg = fleet.get_hybrid_communicate_group()
        model = TensorParallel(build(), hcg)
        opt = fleet.distributed_optimizer(workers._adamw(model))
        step = train_step(model, None, opt, mesh=hcg.mesh,
                          step_fn=workers._step_fn)
        got = [float(step(*batch)) for _ in range(workers.STEPS)]
        assert got == want
        for (n, p), q in zip(model._layers.named_parameters(),
                             plain.parameters()):
            assert torch.equal(p, q), n
    finally:
        _clear_torch_hcg()
        tdist.destroy_process_group()


def test_train_step_refuses_a_plain_optimizer_for_a_split_model():
    """A tensor-parallel model's gradients are reduced by the hybrid
    optimizer: a plain one over data ranks is refused."""
    from paddle_tpu_torch.jit.train_step import _DataShard

    class _Mesh:
        shape = {"dp": 2, "mp": 2}

        def group(self, axes):
            return types.SimpleNamespace(rank=0, ranks=[0, 2])
    from paddle_tpu_torch.distributed.fleet.meta_parallel.parallel_layers \
        import mp_layers
    model = mp_layers.ColumnParallelLinear(2, 2, device="cpu")
    model.world_size = 2          # as a layer built under mp 2 records it
    with pytest.raises(ValueError, match="HybridParallelOptimizer"):
        _DataShard(_Mesh(), None, model,
                   optimizer.AdamW(parameters=model.parameters()))
