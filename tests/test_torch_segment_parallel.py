"""The port's sequence sharding: ring attention (cp) and Ulysses (sep),
alone and under training with mp, across 4 gloo ranks, against the JAX
package (``tests/test_ring_ulysses.py``, ``tests/test_segment_parallel.py``).

One 4-rank group (``tests/torch_dist_workers.py segment_parallel``,
started by the port's launcher with ``--device cpu``):

* ``ring_attention_bhsd`` over the 4 ranks on ``[BH, S / 4, D]`` chunks
  and ``ulysses_attention`` on ``[B, S / 4, H, D]``, causal and not, with
  the gradients of ``sum(out * w)``: against the JAX ``ring_attention_bhsd``
  / ``ulysses_attention`` under ``shard_map`` over a 4-device mesh, and
  the JAX plain attention, on the same numpy inputs
  (``test_ring_ulysses.py``'s shapes: S 512, D 64, scale 0.125);
* ``test_segment_parallel.py``'s runs: the tiny GPT at sep 4 and cp 4
  (4 heads) and at sep 2 x mp 2 and cp 2 x mp 2 (8 heads), its GQA LLaMA
  (4 heads over 2) at sep 2 x mp 2 and cp 2 x mp 2, 3 steps each through
  fleet's wrappers and ``TrainStep(mesh=...)`` on its batch, against the
  JAX runs at its settings (dp 2 x those degrees on 8 devices; the
  weights carried from them);
* the fallback: sep 4 over 6 heads, one warning, and the gathered
  sequence's logits against the JAX run's.

In process: the factored ring schedule (the 4 ranks' steps in turn) against
plain attention over the whole sequence, and the ring's and Ulysses'
shape errors.

Tolerances: attention values and gradients ``atol = 3e-5`` / ``3e-4``
(``test_ring_ulysses.py``'s), losses ``rtol = 3e-4``
(``test_segment_parallel.py``'s for GQA, the GPT runs held to it too),
parameters after 3 steps ``atol = 1e-4``, the fallback's logits ``atol =
1e-5`` (fp32, attention over the gathered sequence).
"""
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.communication.group import _reset_groups
from paddle_tpu.distributed.fleet.base.topology import _clear_hcg
from paddle_tpu.distributed.fleet.meta_parallel import (
    segment_parallel as jseg)
from paddle_tpu.distributed.mesh import reset_mesh
from paddle_tpu.jit import train_step as jax_train_step
from paddle_tpu.models import GPTForPretraining as JaxGPT
from paddle_tpu.models import gpt_config as jax_gpt_config
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.ops.flash_attention import reference_attention_bhsd as jref
from paddle_tpu.ops.ring_attention import ring_attention_bhsd as jring
from paddle_tpu.ops.ulysses import ulysses_attention as julysses

from paddle_tpu_torch.ops import ring_attention as tring
from paddle_tpu_torch.ops.flash_attention import reference_attention_bhsd
from paddle_tpu_torch.ops.ulysses import ulysses_attention

import torch_dist_workers as workers
from torch_dist_workers import launch, wait_ranks

N = workers.N_RANKS
RUNS = list(workers.SEG_RUNS)
VAL_ATOL = 3e-5
GRAD_ATOL = 3e-4
LOSS_RTOL = 3e-4
PARAM_ATOL = 1e-4
FALLBACK_ATOL = 1e-5
S, D, BH, B, H = 512, 64, 2, 2, 8
SCALE = 0.125


def _fresh():
    reset_mesh()
    _reset_groups()
    _clear_hcg()


def attention_inputs():
    rs = np.random.RandomState(0)

    def f(*shape):
        return rs.randn(*shape).astype(np.float32)
    return dict(q=f(BH, S, D), k=f(BH, S, D), v=f(BH, S, D),
                w=np.cos(np.arange(D)).astype(np.float32),
                uq=f(B, S, H, D), uk=f(B, S, H, D), uv=f(B, S, H, D))


def _jax_attention(a):
    """The JAX ring and Ulysses under ``shard_map`` over 4 devices, and
    its plain attention: values and the gradients of ``sum(out * w)``."""
    mesh = Mesh(np.array(jax.devices()[:N]), ("cp",))
    w = jnp.asarray(a["w"])
    out = {}
    for causal in (False, True):
        def ring(q, k, v, c=causal):
            return jax.shard_map(
                lambda q, k, v: jring(q, k, v, "cp", SCALE, c, True),
                mesh=mesh, in_specs=P(None, "cp", None),
                out_specs=P(None, "cp", None), check_vma=False)(q, k, v)

        def uly(q, k, v, c=causal):
            return jax.shard_map(
                lambda q, k, v: julysses(q, k, v, "cp", SCALE, c, True),
                mesh=mesh, in_specs=P(None, "cp", None, None),
                out_specs=P(None, "cp", None, None),
                check_vma=False)(q, k, v)

        def plain(q, k, v, c=causal):
            return jref(q, k, v, SCALE, c)

        def plain_bshd(q, k, v, c=causal):
            t = [jnp.swapaxes(x, 1, 2).reshape(B * H, S, D)
                 for x in (q, k, v)]
            return jnp.swapaxes(jref(*t, SCALE, c).reshape(B, H, S, D), 1, 2)

        tag = "causal" if causal else "full"
        for name, fn, keys in (("ring", ring, "qkv"),
                               ("ring_plain", plain, "qkv"),
                               ("ulysses", uly, ("uq", "uk", "uv")),
                               ("ulysses_plain", plain_bshd,
                                ("uq", "uk", "uv"))):
            xs = [jnp.asarray(a[k]) for k in keys]

            def loss(*x, f=fn):
                o = f(*x)
                return jnp.sum(o * w), o
            (_, vals), grads = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1, 2), has_aux=True))(*xs)
            out[f"{name}_{tag}"] = dict(
                out=np.asarray(vals), dq=np.asarray(grads[0]),
                dk=np.asarray(grads[1]), dv=np.asarray(grads[2]))
    return out


def _jax_model(kind, heads=None, hidden=None):
    if kind == "gpt":
        paddle.seed(7)
        extra = {} if hidden is None else dict(hidden_size=hidden)
        return JaxGPT(jax_gpt_config("tiny", hidden_dropout_prob=0.0,
                                     attention_dropout_prob=0.0,
                                     num_heads=heads, **extra))
    paddle.seed(11)
    return JaxLlama(JaxLlamaConfig(**workers.SEG_LLAMA))


def _weights(model):
    return {k: np.asarray(v._data) for k, v in model.state_dict().items()}


def _jax_fleet(degrees):
    _fresh()
    s = jfleet.DistributedStrategy()
    s.hybrid_configs = dict(degrees)
    jfleet.init(is_collective=True, strategy=s)


def _jax_run(kind, degrees, heads):
    """``test_segment_parallel.py``'s run at dp 2 x ``degrees``."""
    _jax_fleet(dict(dp_degree=2, **degrees))
    model = _jax_model(kind, heads)
    weights = _weights(model)
    opt = jopt.AdamW(learning_rate=workers.LR, parameters=model.parameters())
    step = jax_train_step(model, model.loss_fn, opt)
    batch = workers.seg_batch(model.config.vocab_size,
                              0 if kind == "gpt" else 1)
    losses = [float(step(*batch)) for _ in range(workers.STEPS)]
    params = {n: np.asarray(p._data) for n, p in model.named_parameters()}
    _fresh()
    return weights, losses, params


def _jax_fallback():
    """``test_unsupported_shape_warns_and_falls_back``'s model and input
    (sep 4 over 6 heads): its logits.  The JAX package warns once a
    process (``segment_parallel._warned``): the set is restored after the
    run, so that test still sees its warning on this worker."""
    saved = set(jseg._warned)
    try:
        _jax_fleet(dict(dp_degree=2, sep_degree=4))
        model = _jax_model("gpt", 6, 48)
        weights = _weights(model)
        with warnings.catch_warnings(record=True):
            warnings.simplefilter("always")
            logits = model(paddle.to_tensor(np.zeros((8, 32),
                                                     dtype=np.int64)))
        logits = np.asarray(logits._data)
    finally:
        jseg._warned.clear()
        jseg._warned.update(saved)
        _fresh()
    return weights, logits


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("segment_parallel")
    _fresh()
    a = attention_inputs()
    np.savez(out / "attn.npz", **a)
    weights = {"gpt4": _weights(_jax_model("gpt", 4)),
               "gpt8": _weights(_jax_model("gpt", 8)),
               "llama": _weights(_jax_model("llama")),
               "fallback": _weights(_jax_model("gpt", 6, 48))}
    for k, w in weights.items():
        np.savez(out / f"{k}.npz", **w)
    proc = launch("segment_parallel", out, out / "logs", str(out),
                  threads=2)
    try:
        want = {"attention": _jax_attention(a)}
        for tag, (kind, degrees, heads) in workers.SEG_RUNS.items():
            init, losses, params = _jax_run(kind, degrees, heads)
            key = f"gpt{heads}" if kind == "gpt" else "llama"
            for n, x in weights[key].items():             # one init
                np.testing.assert_array_equal(init[n], x)
            want[tag] = (losses, params)
        init, want["fallback"] = _jax_fallback()
        for n, x in weights["fallback"].items():
            np.testing.assert_array_equal(init[n], x)
    except BaseException:
        proc.kill()
        proc.communicate()
        raise
    arrays, info = wait_ranks(proc, out, out / "logs")
    return want, arrays, info


ATTN = [f"{op}_{c}" for op in ("ring", "ulysses") for c in ("full",
                                                             "causal")]


def _chunks(arrays, key):
    return np.concatenate([arrays[r][key] for r in range(N)], axis=1)


@pytest.mark.parametrize("case", ATTN)
def test_attention_values_match_jax(runs, case):
    """Each rank's output chunk, concatenated, against the JAX
    ``shard_map`` run and the plain attention over the whole sequence."""
    want, arrays, _ = runs
    got = _chunks(arrays, f"{case}/out")
    op, tag = case.split("_")
    for ref in (want["attention"][case], want["attention"][
            f"{op}_plain_{tag}"]):
        np.testing.assert_allclose(got, ref["out"], rtol=VAL_ATOL,
                                   atol=VAL_ATOL)


@pytest.mark.parametrize("case", ATTN)
@pytest.mark.parametrize("grad", ["dq", "dk", "dv"])
def test_attention_gradients_match_jax(runs, case, grad):
    """dq at home, dk / dv carried home by the ring (or the inverse
    all-to-all), against the JAX ``shard_map`` run's and the plain
    attention's gradients."""
    want, arrays, _ = runs
    got = _chunks(arrays, f"{case}/{grad}")
    op, tag = case.split("_")
    for ref in (want["attention"][case], want["attention"][
            f"{op}_plain_{tag}"]):
        np.testing.assert_allclose(got, ref[grad], rtol=GRAD_ATOL,
                                   atol=GRAD_ATOL)


@pytest.mark.parametrize("tag", RUNS)
def test_sequence_sharded_losses_match_jax(runs, tag):
    want, _, info = runs
    for r in range(N):
        np.testing.assert_allclose(info[r][tag], want[tag][0],
                                   rtol=LOSS_RTOL, err_msg=f"rank {r}")
    assert info[0][tag][-1] < info[0][tag][0]


@pytest.mark.parametrize("tag", RUNS)
def test_sequence_sharded_parameters_match_jax(runs, tag):
    want, arrays, _ = runs
    for name, ref in want[tag][1].items():
        np.testing.assert_allclose(arrays[0][f"{tag}/{name}"], ref, rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)


@pytest.mark.parametrize("tag", RUNS)
def test_every_attention_took_the_sequence_parallel_route(runs, tag):
    """Each layer's attention, forward once a step, took the run's route
    on every rank (3 steps x 2 layers), and none fell back."""
    _, _, info = runs
    route = "sep" if "sep" in tag else "cp"
    for r in range(N):
        got = info[r][f"{tag}_routes"]
        assert got[route] == workers.STEPS * 2 and got["fallback"] == 0, got


def test_unsupported_shape_warns_and_falls_back(runs):
    """sep 4 over 6 heads: one warning naming sep and heads, the fallback
    route once a layer, and the logits of the gathered sequence equal to
    the JAX run's (attention over a rank's chunk alone would differ)."""
    want, arrays, info = runs
    for r in range(N):
        msgs = info[r]["fallback_warnings"]
        assert len(msgs) == 1 and "sep" in msgs[0] and "heads" in msgs[0]
        assert info[r]["fallback_routes"] == dict(sep=0, cp=0, fallback=2)
    np.testing.assert_allclose(arrays[0]["fallback/logits"],
                               want["fallback"], rtol=0, atol=FALLBACK_ATOL)


def test_jax_fallback_leaves_the_warning_for_later_tests(runs):
    """After ``_jax_fallback`` ran in this process (the module fixture),
    ``test_segment_parallel.py``'s fallback run still warns: the JAX
    package's once-a-process set is as it was before."""
    import test_segment_parallel as jtest
    saved = set(jseg._warned)
    jseg._warned.discard("sep-heads")    # as a fresh worker holds it
    before = set(jseg._warned)
    try:
        _jax_fallback()
        assert jseg._warned == before
        _fresh()
        jtest.test_unsupported_shape_warns_and_falls_back()
    finally:
        jseg._warned.clear()
        jseg._warned.update(saved)
        _fresh()


@pytest.mark.parametrize("causal", [False, True])
def test_factored_ring_schedule_matches_plain_attention(causal,
                                                        monkeypatch):
    """The 4 ranks' ring schedules run in turn in one process on chunks of
    one sequence: outputs and gradients equal plain attention over the
    whole sequence; a causal ring attends rank r's chunk r + 1 times
    (the masked chunks call nothing), a full one 4 times."""
    rs = np.random.RandomState(3)
    q, k, v, do = (torch.tensor(rs.randn(BH, S, D).astype(np.float32))
                   for _ in range(4))
    calls = {"fwd": [], "bwd": []}
    for key, name in (("fwd", "_chunk_fwd"), ("bwd", "_chunk_bwd")):
        real = getattr(tring, name)

        def counted(*a, _real=real, _key=key):
            res = _real(*a)
            if res is not None:
                calls[_key].append(a[-3] // (S // N))     # q_off -> rank
            return res
        monkeypatch.setattr(tring, name, counted)
    chunks = [t.chunk(N, dim=1) for t in (q, k, v, do)]
    res = tring.ring_schedule_fwd(*chunks[:3], SCALE, causal)
    outs, lses = [o for o, _ in res], [lse for _, lse in res]
    grads = tring.ring_schedule_bwd(*chunks[:3], outs, lses, chunks[3],
                                    SCALE, causal)
    qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
    ref, ref_lse = reference_attention_bhsd(qq, kk, vv, SCALE, causal,
                                            return_lse=True)
    ref.backward(do)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(),
                               ref.detach().numpy(), rtol=0, atol=VAL_ATOL)
    np.testing.assert_allclose(torch.cat(lses, 1).numpy(),
                               ref_lse.detach().numpy(), rtol=0,
                               atol=VAL_ATOL)
    for i, t in enumerate((qq, kk, vv)):
        np.testing.assert_allclose(torch.cat([g[i] for g in grads],
                                             1).numpy(),
                                   t.grad.numpy(), rtol=0, atol=GRAD_ATOL)
    for key in ("fwd", "bwd"):
        want = [r + 1 if causal else N for r in range(N)]
        assert [calls[key].count(r) for r in range(N)] == want


def test_ring_and_ulysses_shape_errors():
    """The reference's errors: a per-rank length off the flash block, and
    heads or a global sequence Ulysses cannot split."""
    four = types.SimpleNamespace(nranks=4)
    with pytest.raises(ValueError, match="aligned"):
        tring.ring_attention_bhsd(*[torch.zeros(1, 130, 8)] * 3, four, 1.0)
    with pytest.raises(ValueError, match="heads"):
        ulysses_attention(*[torch.zeros(1, 8, 6, 8)] * 3, four, 1.0)
    with pytest.raises(ValueError, match="aligned"):
        ulysses_attention(*[torch.zeros(1, 33, 4, 8)] * 3, four, 1.0)
