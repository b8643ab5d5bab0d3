"""The global-norm clip and ``amp.GradScaler`` of the port over 4 gloo
ranks (``tests/torch_dist_workers.py hybrid_clip``) against the JAX
package, whose arrays are global, so its clip's norm and its scaler's
flag are global by construction.

The ranks train, for 4 fp32 steps on one global batch 8 x 32, with
AdamW(1e-3) under ``ClipGradByGlobalNorm(0.5)`` (below every step's
norm, so it clips) and ``GradScaler(2 ** 10)``:

* example 03's form: the tiny GPT at dp 2 x sharding 2, stage 1 through
  ``fleet.distributed_model`` / ``distributed_optimizer``, stages 2 and
  3 through ``group_sharded_parallel`` over the dp x sharding group,
  each through ``train_step(..., scaler=, mesh=hcg.mesh)``;
* example 04's form: a tiny GQA LLaMA (4 layers, 8 heads over 4) with
  sequence parallelism and recompute at mp 4 and at mp 2 x dp 2,
  through ``fleet``'s wrappers and ``train_step``;
* the same LLaMA through ``llama_pipeline_step(scaler=)`` at pp 4 and
  mp 2 x pp 2 (4 micro-batches, 1F1B);
* ``ClipGradByNorm`` at mp 4 with SP on the first step's gradients:
  each parameter's whole norm against the JAX gradient's.

At step 2 rank 3 alone sets one element of its gradient (or gradient
shard) to ``inf``, after the reductions.  Held, on every rank: that
step skipped (every parameter, master, moment and beta power the rank
holds bit-equal to before, its loss equal to the next step's, which
trains from the same weights), the scale halved, and only rank 3's own
flag raised (the flags before the all-reduce: the control); the other
steps' losses and the final parameters against the JAX package's 3
steps with the same clip and scaler (GPT at dp 2 x sharding 4, LLaMA at
dp 2 x mp 4 with SP, its fleet meshes of 8 CPU devices); the first
step's global norm against the norm of the JAX model's gradients
(eager, one device); and each rank's own share of the norm, before the
group sum, missing it (the control).

Tolerances: losses ``rtol = 2e-4`` and parameters ``atol = 1e-4`` (the
data-parallel tests'), ``3e-4`` / ``1e-4`` for the pipeline steps (the
pipeline tests'); the norm ``rtol = 1e-5`` (fp32 sums in another order);
a share misses by more than ``1e-3`` relative.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu import amp as jamp
from paddle_tpu.core.tensor import Tensor
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
RUNS = list(workers.HC_RUNS)
POISON = workers.HC_POISON_STEP
LOSS_RTOL = {"gpt": 2e-4, "fleet": 2e-4, "pipeline": 3e-4}
PARAM_ATOL = 1e-4
NORM_RTOL = 1e-5
SHARE_MISS = 1e-3
JAX_DEGREES = {"gpt": (dict(dp_degree=2, sharding_degree=4), False),
               "llama": (dict(dp_degree=2, mp_degree=4), True)}
SEEDS = {"gpt": 7, "llama": 11}


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
    return JaxLlama(JaxLlamaConfig(**workers.HC_LLAMA, sequence_parallel=sp,
                                   use_recompute=sp))


def _batch(kind):
    return workers.global_batch() if kind == "gpt" else \
        workers.tp_batch(workers.HC_LLAMA["vocab_size"])


def _jax_norm(kind):
    """The global norm of the first step's gradients and each
    parameter's: the JAX model on one device, eager."""
    _fresh()
    model = _jax_model(kind)
    ids, labels = _batch(kind)
    model.loss_fn(model(Tensor(paddle.to_tensor(ids)._data)),
                  paddle.to_tensor(labels)).backward()
    each = {n: float(np.sqrt(np.sum(np.asarray(p._grad._data,
                                               np.float64) ** 2)))
            for n, p in model.named_parameters() if p._grad is not None}
    return float(np.sqrt(sum(v * v for v in each.values()))), each


def _jax_run(kind):
    """The JAX package's 3 steps with the clip and the scaler at
    ``JAX_DEGREES``: initial weights, losses, final parameters."""
    degrees, sp = JAX_DEGREES[kind]
    _fresh()
    s = jfleet.DistributedStrategy()
    s.hybrid_configs = dict(degrees)
    jfleet.init(is_collective=True, strategy=s)
    model = _jax_model(kind, sp)
    weights = {k: np.asarray(v._data) for k, v in model.state_dict().items()}
    opt = jopt.AdamW(learning_rate=workers.LR, parameters=model.parameters(),
                     grad_clip=jnn.ClipGradByGlobalNorm(workers.HC_CLIP))
    scaler = jamp.GradScaler(init_loss_scaling=workers.HC_SCALE)
    step = jax_train_step(model, model.loss_fn, opt, scaler=scaler)
    batch = _batch(kind)
    losses = [float(step(*batch)) for _ in range(workers.HC_STEPS - 1)]
    params = {n: np.asarray(p._data) for n, p in model.named_parameters()}
    _fresh()
    return weights, losses, params


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("hybrid_clip")
    want = {}
    for kind in ("gpt", "llama"):
        norm, each = _jax_norm(kind)
        weights, losses, params = _jax_run(kind)
        np.savez(out / f"{kind}.npz", **weights)
        want[kind] = dict(norm=norm, each=each, losses=losses,
                          params=params)
    logs = out / "logs"
    proc = launch("hybrid_clip", out, logs, str(out), threads=2)
    arrays, info = wait_ranks(proc, out, logs)
    return want, arrays, info


def _kind(tag):
    return workers.HC_RUNS[tag][0]


def _wrap(tag):
    return workers.HC_RUNS[tag][2]


@pytest.mark.parametrize("tag", RUNS)
def test_losses_match_jax_and_the_skip_repeats_a_step(runs, tag):
    want, _, info = runs
    rtol = LOSS_RTOL["pipeline" if _wrap(tag) == "pipeline" else "fleet"]
    for r in range(N):
        losses = info[r][tag]["losses"]
        assert losses[POISON] == losses[POISON + 1], (r, losses)
        kept = losses[:POISON] + losses[POISON + 1:]
        np.testing.assert_allclose(kept, want[_kind(tag)]["losses"],
                                   rtol=rtol, err_msg=f"rank {r}")


@pytest.mark.parametrize("tag", RUNS)
def test_parameters_match_jax(runs, tag):
    want, arrays, _ = runs
    ref = want[_kind(tag)]["params"]
    seen = set()
    for r in range(N):
        for key, a in arrays[r].items():
            if not key.startswith(f"{tag}/"):
                continue
            name = key.split("/", 1)[1]
            seen.add(name)
            np.testing.assert_allclose(a, ref[name], rtol=0,
                                       atol=PARAM_ATOL,
                                       err_msg=f"rank {r} {name}")
    assert seen == set(ref)


@pytest.mark.parametrize("tag", RUNS)
def test_global_norm_matches_jax_and_a_share_misses(runs, tag):
    want, _, info = runs
    norm = want[_kind(tag)]["norm"]
    assert norm > workers.HC_CLIP                 # the clip is active
    for r in range(N):
        rec = info[r][tag]
        np.testing.assert_allclose(rec["norms"][0], norm, rtol=NORM_RTOL,
                                   err_msg=f"rank {r}")
        share = rec["local_norms"][0]
        assert abs(share - norm) > SHARE_MISS * norm, (r, share, norm)


@pytest.mark.parametrize("tag", RUNS)
def test_one_rank_poisoned_every_rank_skips(runs, tag):
    _, _, info = runs
    for r in range(N):
        rec = info[r][tag]
        assert rec["skip_bit_equal"], r
        scales = rec["scales"]
        assert scales[POISON] == scales[POISON - 1] / 2, (r, scales)
        assert scales[POISON + 1] == scales[POISON], (r, scales)
        flags = rec["local_flags"]
        want = [1.0 if (i == POISON and r == workers.HC_POISON_RANK)
                else 0.0 for i in range(workers.HC_STEPS)]
        assert flags == want, (r, flags)
        assert rec["host_reads"] == workers.HC_STEPS, r


def test_clip_by_norm_sums_split_tensors_over_mp(runs):
    """``ClipGradByNorm`` at mp 4 with SP: each parameter's norm is its
    whole gradient's (a split one's squares summed over mp), the JAX
    gradient's within ``NORM_RTOL``, and the clipped gradient's norm is
    ``min(norm, clip)`` on every rank."""
    want, _, info = runs
    each = want["llama"]["each"]
    for r in range(N):
        got = info[r]["clip_by_norm_mp4"]
        assert set(got) == set(each)
        for n, (before, after) in got.items():
            np.testing.assert_allclose(before, each[n], rtol=NORM_RTOL,
                                       err_msg=f"rank {r} {n}")
            np.testing.assert_allclose(after, min(before, workers.HC_CLIP),
                                       rtol=NORM_RTOL,
                                       err_msg=f"rank {r} {n}")
        assert any(b > workers.HC_CLIP for b, _ in got.values())
