"""The port's ``distributed.checkpoint`` over 4 gloo ranks
(``tests/torch_dist_workers.py checkpoint`` and ``checkpoint_crash``, two
launches run side by side) against the JAX package.

* Example 03's form: the tiny GPT at dp 2 x sharding 2, ZeRO stage 2
  (``os_g``) over the dp x sharding group, fp32 AdamW(1e-3) with
  ``ClipGradByGlobalNorm(0.5)`` and ``GradScaler(2 ** 10)`` through
  ``train_step``, trains 2 steps and saves ``{"model":
  inner.state_dict(), "opt": opt.state_dict(), "scaler":
  scaler.state_dict()}``.  A fresh model at the same layout loads it
  and trains steps 3-4: bit-equal to the uninterrupted 4-step run (its
  losses and every parameter).  One under sharding 4 ``p_g_os`` loads
  it (parameters and moments exactly the saved gathered state) and
  trains steps 3-4, and so does a plain model in this process (a world
  of one): their losses against the JAX package's 4-step run of the
  same model (``rtol 2e-4``) and their parameters (``atol 1e-4``), the
  data-parallel tests' tolerances.  The control: a load into the stage-3
  wrapper's ``state_dict()``, which is gathered copies, leaves the model
  as it was built.
* The tiny LLaMA at mp 4 (q / k / v column-split, o / down row-split,
  the vocabulary-split head) saves the same way; it loads at mp 2 x dp 2
  and at one rank, each held the same way.
* Every rank takes the sharded optimizer's ``state_dict()`` (gathered
  at the call) and rank 0 alone writes it with ``paddle_tpu_torch.save``:
  the file holds the saved moments, and each rank's dict still holds
  them after two more steps.
* Each rank's data file holds exactly the bytes of the elements it
  owns: rank 0 the replicated model and every parameter's beta powers,
  each rank its ZeRO shard's moments (no padding, no headers).
* ``ckpt_write@1=crash`` on rank 3 alone kills it between its write and
  the commit of version 1: the launcher fails, version 1 has no
  ``_COMMIT``, and the next load (one rank, here) takes version 0.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu import amp as jamp
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.communication.group import _reset_groups
from paddle_tpu.distributed.fleet.base.topology import _clear_hcg
from paddle_tpu.distributed.mesh import reset_mesh
from paddle_tpu.jit import train_step as jax_train_step
from paddle_tpu.models import GPTForPretraining as JaxGPT
from paddle_tpu.models import gpt_config as jax_gpt_config
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama

import torch_dist_workers as workers
from torch_dist_workers import launch, wait_ranks

N = workers.N_RANKS
SAVE_AT, STEPS = workers.CK_SAVE_AT, workers.CK_STEPS
LOSS_RTOL, PARAM_ATOL = 2e-4, 1e-4
# the JAX runs' layouts (8 CPU devices)
JAX_DEGREES = {"gpt": dict(dp_degree=2, sharding_degree=4),
               "llama": dict(dp_degree=2, mp_degree=4)}
SEEDS = {"gpt": 7, "llama": 11}


def _fresh():
    reset_mesh()
    _reset_groups()
    _clear_hcg()


def _jax_model(kind):
    paddle.seed(SEEDS[kind])
    if kind == "gpt":
        return JaxGPT(jax_gpt_config("tiny", hidden_dropout_prob=0.0,
                                     attention_dropout_prob=0.0))
    return JaxLlama(JaxLlamaConfig(**workers.TP_LLAMA))


def _batch(kind):
    return workers.global_batch() if kind == "gpt" else \
        workers.tp_batch(workers.TP_LLAMA["vocab_size"])


def _jax_weights(kind):
    _fresh()
    return {k: np.asarray(v._data)
            for k, v in _jax_model(kind).state_dict().items()}


def _jax_run(kind):
    """The JAX package's ``STEPS`` steps with the clip and the scaler:
    losses and final parameters."""
    _fresh()
    s = jfleet.DistributedStrategy()
    s.hybrid_configs = dict(JAX_DEGREES[kind])
    jfleet.init(is_collective=True, strategy=s)
    model = _jax_model(kind)
    opt = jopt.AdamW(learning_rate=workers.LR, parameters=model.parameters(),
                     grad_clip=jnn.ClipGradByGlobalNorm(workers.HC_CLIP))
    scaler = jamp.GradScaler(init_loss_scaling=workers.HC_SCALE)
    step = jax_train_step(model, model.loss_fn, opt, scaler=scaler)
    batch = _batch(kind)
    losses = [float(step(*batch)) for _ in range(STEPS)]
    params = {n: np.asarray(p._data) for n, p in model.named_parameters()}
    _fresh()
    return losses, params


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("checkpoint")
    crash = tmp_path_factory.mktemp("checkpoint_crash")
    for kind in ("gpt", "llama"):
        np.savez(out / f"{kind}.npz", **_jax_weights(kind))
    procs = [launch("checkpoint", out, out / "logs", str(out), threads=2),
             launch("checkpoint_crash", crash, crash / "logs", str(out),
                    threads=1)]
    want = {kind: _jax_run(kind) for kind in ("gpt", "llama")}
    arrays, info = wait_ranks(procs[0], out, out / "logs")
    try:
        text, _ = procs[1].communicate(timeout=workers.LAUNCH_TIMEOUT_S)
    except Exception:
        procs[1].kill()
        raise
    return dict(out=out, crash=crash, crash_rc=procs[1].returncode,
                crash_text=text, want=want, arrays=arrays, info=info)


def _one_rank(kind, path, clip=True):
    """A plain model in this process (no process group) loads example
    03's dict from ``path`` and trains steps 3-4: its loaded parameters,
    its losses, its final parameters and the load's info."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.distributed import checkpoint as dck
    from paddle_tpu_torch.jit import train_step
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    weights = dict(np.load(os.path.join(path, f"{kind}.npz"))) \
        if os.path.exists(os.path.join(path, f"{kind}.npz")) else None
    model = workers.tp_model(kind, weights, llama=workers.TP_LLAMA)
    opt = optimizer.AdamW(learning_rate=workers.LR,
                          parameters=model.parameters(),
                          grad_clip=ClipGradByGlobalNorm(workers.HC_CLIP))
    scaler = amp.GradScaler(init_loss_scaling=workers.HC_SCALE)
    state = workers._ck_state(model, opt, scaler)
    dck.load_state_dict(state, os.path.join(path, "ck", kind))
    scaler.set_state_dict(state["scaler"])
    info = dck.last_load_info()
    loaded = {n: p.detach().numpy().copy()
              for n, p in model.named_parameters()}
    step = train_step(model, None, opt, scaler=scaler,
                      step_fn=workers._step_fn)
    batch = _batch(kind)
    losses = [float(step(*batch)) for _ in range(STEPS - SAVE_AT)]
    final = {n: p.detach().numpy().copy()
             for n, p in model.named_parameters()}
    return loaded, losses, final, info


def _held(losses, final, want, what):
    jl, jp = want
    np.testing.assert_allclose(losses, jl[SAVE_AT:], rtol=LOSS_RTOL,
                               err_msg=what)
    assert set(final) == set(jp), what
    for n, a in final.items():
        np.testing.assert_allclose(a, jp[n], rtol=0, atol=PARAM_ATOL,
                                   err_msg=f"{what} {n}")


def test_same_layout_resumes_bit_equal(runs):
    for r in range(N):
        assert runs["info"][r]["gpt_os_g_load"]["bit_equal"], r
        assert runs["info"][r]["gpt_os_g_load"]["version"] == str(SAVE_AT)


def test_the_uninterrupted_run_matches_jax(runs):
    """The saving runs themselves hold against the JAX package."""
    for kind, tag in (("gpt", "gpt_os_g"), ("llama", "llama_mp4")):
        for r in range(N):
            np.testing.assert_allclose(
                runs["info"][r][tag]["losses"], runs["want"][kind][0],
                rtol=LOSS_RTOL, err_msg=f"{tag} rank {r}")


@pytest.mark.parametrize("tag", ["gpt_p_g_os", "llama_mp2_dp2"])
def test_resharded_load_is_exact_and_trains_as_jax(runs, tag):
    kind = workers.CK_RUNS[tag][0]
    for r in range(N):
        rec = runs["info"][r][tag + "_load"]
        assert rec["values_exact"] and rec["moments_exact"], (r, rec)
        assert rec["scale"] == workers.HC_SCALE
        np.testing.assert_allclose(rec["losses"],
                                   runs["want"][kind][0][SAVE_AT:],
                                   rtol=LOSS_RTOL, err_msg=f"rank {r}")
    final = {k.split("/", 1)[1]: a for k, a in runs["arrays"][0].items()
             if k.startswith(tag + "_load/")}
    _held(runs["info"][0][tag + "_load"]["losses"], final,
          runs["want"][kind], tag)


def test_a_load_into_gathered_copies_leaves_the_model(runs):
    for r in range(N):
        rec = runs["info"][r]["gpt_p_g_os_load"]
        assert rec["copies_took_values"] and rec["copies_left_model"], r


@pytest.mark.parametrize("kind", ["gpt", "llama"])
def test_one_rank_loads_the_four_rank_save(runs, kind):
    loaded, losses, final, info = _one_rank(kind, str(runs["out"]))
    assert info["version"] == str(SAVE_AT) and info["committed"]
    saved = {k.split("/", 1)[1]: a for k, a in runs["arrays"][0].items()
             if k.startswith(f"{kind}_saved/")}
    assert set(saved) == set(loaded)
    for n, a in saved.items():
        assert np.array_equal(loaded[n], a), n
    _held(losses, final, runs["want"][kind], f"{kind} at one rank")


def test_rank_0_alone_saves_the_sharded_optimizer_state(runs):
    """``opt.state_dict()`` gathers at the call, so rank 0 alone can
    write it (``paddle_tpu_torch.save``), and the dict keeps the state of
    the call after later steps."""
    from paddle_tpu_torch import load
    sd = load(os.path.join(str(runs["out"]), "gpt_opt.pdopt"))
    moments = {k.split("/", 1)[1]: a for k, a in runs["arrays"][0].items()
               if k.startswith("gpt_saved_moments/")}
    weights = dict(np.load(os.path.join(str(runs["out"]), "gpt.npz")))
    named = [n for n, _ in workers.tp_model("gpt", weights)
             .named_parameters()]
    assert len(sd["state"]) == len(named) > 0
    for i, v in sd["state"].items():
        for k in ("moment1", "moment2"):
            assert np.array_equal(v[k].numpy(), moments[f"{named[i]}/{k}"]), \
                (named[i], k)
    for r in range(N):
        assert runs["info"][r]["gpt_os_g"]["opt_state_dict_kept"], r


def test_each_rank_writes_the_bytes_it_owns(runs):
    total = 0
    for r in range(N):
        rec = runs["info"][r]["gpt_os_g"]
        assert rec["data_bytes"] == rec["owned_bytes"], (r, rec)
        total += rec["data_bytes"]
    # every element once: the model (fp32) + beta powers + both moments
    n_params = sum(a.size for k, a in runs["arrays"][0].items()
                   if k.startswith("gpt_saved/"))
    n_tensors = sum(1 for k in runs["arrays"][0]
                    if k.startswith("gpt_saved/"))
    assert total == 4 * n_params + 8 * n_tensors + 8 * n_params
    for r in range(N):                  # mp 4: each rank its shards
        assert runs["info"][r]["llama_mp4"]["data_bytes"] > 0, r


def test_a_rank_crashing_mid_save_leaves_no_commit(runs):
    from paddle_tpu_torch.distributed import checkpoint as dck
    assert runs["crash_rc"] != 0, runs["crash_text"]
    ck = os.path.join(str(runs["crash"]), "ck")
    assert os.path.exists(os.path.join(ck, "0", dck.COMMIT_FILE))
    assert not os.path.exists(os.path.join(ck, "1", dck.COMMIT_FILE))
    assert os.path.exists(os.path.join(ck, "1", "3_0.distcp"))
    assert dck.latest_committed(ck)[0].endswith(os.sep + "0")
    model = workers.tp_model("gpt", dict(np.load(os.path.join(
        str(runs["out"]), "gpt.npz"))))
    with pytest.warns(UserWarning, match="no _COMMIT"):
        dck.load_state_dict({"model": model.state_dict()}, ck)
    info = dck.last_load_info()
    assert info["version"] == "0" and info["metadata"] == {"step": SAVE_AT}
    assert [os.path.basename(s) for s in info["skipped"]] == ["1"]
    saved = {k.split("/", 1)[1]: a for k, a in runs["arrays"][0].items()
             if k.startswith("gpt_saved/")}
    for n, p in model.named_parameters():
        assert np.array_equal(p.detach().numpy(), saved[n]), n
