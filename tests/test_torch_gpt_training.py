"""The PyTorch port's GPT training slice held against the JAX package on
the CPU: tiny GPT weights made by ``paddle_tpu`` are carried into
``paddle_tpu_torch``, and both packages' ``train_step`` run the same
numpy batches with AdamW (lr 1e-3, weight decay 0.01, dropout 0).

Tolerances:
* fp32, 10 steps: losses atol 1e-5 and parameters atol 1e-4 (the same
  math in another summation order; Adam's normalised update turns a
  last-bit difference of a small gradient into up to ~1e-5 of a weight
  per step, so the weights drift apart by more than the losses);
* amp O2 bf16, 3 steps: losses atol 3.2e-2, one bf16 ulp of values in
  [4, 8) (the O2 loss is a bf16 value on both sides).  fp32 master
  weights: the median difference of each tensor within 5e-5, every
  element within 6e-3 = 2 x 3 steps x lr.  bf16 activations round at
  other places in XLA and torch; where a gradient is only rounding noise
  (the key bias, whose true gradient is 0 since softmax ignores a shift
  of every key's logit), its sign differs between the two, and Adam's
  normalised step moves such a weight by up to lr either way;
* the criterion: atol 1e-6 (fp32, same formula).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu import amp as jamp
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.jit import train_step as jax_train_step
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.models.gpt import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.models.gpt import gpt_config as jax_gpt_config

from paddle_tpu_torch import amp, optimizer
from paddle_tpu_torch.jit import train_step
from paddle_tpu_torch.models import (GPTForPretraining, gpt_config,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion

_NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
LR, WD = 1e-3, 0.01


def _batch(seed=0, b=2, s=16, vocab=512):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, vocab, (b, s)).astype(np.int64)
    labels = rs.randint(0, vocab, (b, s)).astype(np.int64)
    labels[0, :3] = -100                 # ignored positions in the loss
    return ids, labels


def _pair(o2: bool):
    """A JAX model and the port's model with the same weights, their
    AdamW optimizers, and both step functions (O2 decorated if asked)."""
    paddle.seed(0)
    jm = JaxGPT(jax_gpt_config("tiny", **_NO_DROPOUT))
    arrays = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    pm = GPTForPretraining(gpt_config("tiny", **_NO_DROPOUT), device="cpu")
    load_paddle_tpu_state(pm, arrays)        # carried before the cast
    jo = jopt.AdamW(learning_rate=LR, parameters=jm.parameters(),
                    weight_decay=WD, multi_precision=True)
    po = optimizer.AdamW(learning_rate=LR, parameters=pm.parameters(),
                         weight_decay=WD, multi_precision=True)
    if o2:
        jm, jo = jamp.decorate(models=jm, optimizers=jo, level="O2",
                               dtype="bfloat16")
        pm, po = amp.decorate(models=pm, optimizers=po, level="O2",
                              dtype="bfloat16")

        def jfn(m, ids, labels):
            with jamp.auto_cast(enable=True, level="O2", dtype="bfloat16"):
                return m.loss_fn(m(ids), labels)

        def pfn(m, ids, labels):
            with amp.auto_cast(enable=True, level="O2", dtype="bfloat16"):
                return m.loss_fn(m(ids), labels)
    else:
        def jfn(m, ids, labels):
            return m.loss_fn(m(ids), labels)
        pfn = jfn
    return (jm, jo, jax_train_step(jm, None, jo, step_fn=jfn),
            pm, po, train_step(pm, None, po, step_fn=pfn))


def _run(o2: bool, steps: int):
    jm, jo, jstep, pm, po, pstep = _pair(o2)
    ids, labels = _batch()
    jl = [float(jstep(ids, labels)) for _ in range(steps)]
    pl = [float(pstep(ids, labels)) for _ in range(steps)]
    return jm, jo, jl, pm, po, pl


@pytest.fixture(scope="module")
def fp32_run():
    return _run(False, 10)


@pytest.fixture(scope="module")
def o2_run():
    return _run(True, 3)


def test_fp32_loss_curve_matches_jax(fp32_run):
    jm, _, jl, pm, _, pl = fp32_run
    np.testing.assert_allclose(pl, jl, rtol=0, atol=1e-5)
    assert pl[-1] < pl[0] - 1.0                  # the batch is learned
    want = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0,
                                   atol=1e-4, err_msg=name)


def test_o2_loss_curve_matches_jax(o2_run):
    jm, jo, jl, pm, po, pl = o2_run
    np.testing.assert_allclose(pl, jl, rtol=0, atol=3.2e-2)
    assert pl[-1] < pl[0]
    # fp32 masters of the bf16 parameters; the JAX optimizer keys them
    # by parameter name, or by position when the name is empty
    keys = {n: p.name or f"param_{i}"
            for i, (n, p) in enumerate(jm.named_parameters())}
    jmaster = {n: np.asarray(jo._master_weights[k]) for n, k in keys.items()
               if k in jo._master_weights}
    assert jmaster
    checked = 0
    for name, p in pm.named_parameters():
        master = po.state[p].get("master")
        assert (master is None) == (name not in jmaster), name
        if master is not None:
            diff = np.abs(master.numpy() - jmaster[name])
            assert diff.max() <= 6 * LR, name
            assert np.median(diff) <= 5e-5, name
            checked += 1
    assert checked == len(jmaster)


def test_o2_decorate_keeps_layer_norm_fp32_and_masters_the_rest(o2_run):
    _, _, _, pm, po, _ = o2_run
    for name, p in pm.named_parameters():
        norm = ".ln1." in name or ".ln2." in name or "final_ln" in name
        assert p.dtype == (torch.float32 if norm else torch.bfloat16), name
        st = po.state[p]
        assert st["moment1"].dtype == torch.float32
        if norm:
            assert "master" not in st, name
        else:
            assert st["master"].dtype == torch.float32
            # the bf16 parameter is the master rounded, written in the
            # same pass
            assert torch.equal(p.detach(), st["master"].to(torch.bfloat16))


def test_criterion_masks_ignored_labels():
    """Mean over valid tokens only; fp32, atol 1e-6 against the JAX
    criterion and against the explicit formula."""
    rs = np.random.RandomState(4)
    logits = rs.randn(2, 5, 7).astype(np.float32)
    labels = rs.randint(0, 7, (2, 5)).astype(np.int64)
    labels[0, 1] = labels[1, 3] = labels[1, 4] = -100
    got = GPTPretrainingCriterion()(torch.from_numpy(logits),
                                    torch.from_numpy(labels))
    want = JaxCriterion()(Tensor(logits), Tensor(labels))
    np.testing.assert_allclose(got.item(), float(want), rtol=0, atol=1e-6)
    lp = torch.log_softmax(torch.from_numpy(logits), -1).numpy()
    valid = labels != -100
    picked = np.take_along_axis(lp, np.where(valid, labels, 0)[..., None],
                                -1)[..., 0]
    np.testing.assert_allclose(got.item(), -picked[valid].mean(), rtol=0,
                               atol=1e-6)


def test_dropout_is_reproducible_from_the_seed_and_survives_recompute():
    """Dropout p > 0: the same seed gives the same losses; another seed
    gives others; recomputing blocks in the backward replays the forward's
    dropout bits, so losses and gradients equal the plain run's."""
    ids, labels = _batch(1)

    def losses(seed, recompute=False, steps=2):
        cfg = gpt_config("tiny", hidden_dropout_prob=0.2,
                         attention_dropout_prob=0.2,
                         use_recompute=recompute)
        m = GPTForPretraining(cfg, device="cpu", seed=seed)
        o = optimizer.AdamW(learning_rate=LR, parameters=m.parameters())
        step = train_step(m, None, o,
                          step_fn=lambda m, i, l: m.loss_fn(m(i), l))
        return [float(step(ids, labels)) for _ in range(steps)]

    a, b = losses(3), losses(3)
    assert a == b
    assert losses(4) != a
    assert losses(3, recompute=True) == a

    grads = []
    for recompute in (False, True):
        cfg = gpt_config("tiny", hidden_dropout_prob=0.2,
                         attention_dropout_prob=0.2,
                         use_recompute=recompute)
        m = GPTForPretraining(cfg, device="cpu", seed=5).train()
        m.loss_fn(m(torch.from_numpy(ids)),
                  torch.from_numpy(labels)).backward()
        grads.append([p.grad.clone() for p in m.parameters()])
    for g0, g1 in zip(*grads):
        assert torch.equal(g0, g1)


def test_eval_forward_records_no_graph_and_training_forward_does():
    m = GPTForPretraining(gpt_config("tiny", **_NO_DROPOUT), device="cpu")
    ids = torch.from_numpy(_batch()[0])
    assert not m(ids).requires_grad              # new models are in eval
    assert m.train()(ids).requires_grad


def test_carry_fills_a_decorated_model():
    """fp32 weights carried after ``decorate`` land in the bf16
    parameters, rounded as the JAX cast rounds them (the usual order
    carries first, as the other tests do)."""
    paddle.seed(1)
    jm = JaxGPT(jax_gpt_config("tiny", **_NO_DROPOUT))
    arrays = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    jm = jamp.decorate(models=jm, level="O2", dtype="bfloat16")
    pm = amp.decorate(GPTForPretraining(gpt_config("tiny", **_NO_DROPOUT),
                                        device="cpu"),
                      level="O2", dtype="bfloat16")
    load_paddle_tpu_state(pm, arrays)
    jbf16 = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    for name, p in pm.named_parameters():
        np.testing.assert_array_equal(p.detach().float().numpy(),
                                      jbf16[name].astype(np.float32),
                                      err_msg=name)


def test_unported_options_raise():
    cfg = gpt_config("tiny", sequence_parallel=True)
    with pytest.raises(NotImplementedError, match="sequence_parallel"):
        GPTForPretraining(cfg, device="cpu")
    m = GPTForPretraining(gpt_config("tiny"), device="cpu")
    with pytest.raises(NotImplementedError, match="O1"):
        with amp.auto_cast(enable=True):
            pass
    with pytest.raises(NotImplementedError, match="GradScaler"):
        amp.GradScaler()
    with pytest.raises(NotImplementedError, match="grad_clip"):
        optimizer.AdamW(parameters=m.parameters(), grad_clip=object())
    with pytest.raises(NotImplementedError, match="amsgrad"):
        optimizer.AdamW(parameters=m.parameters(), amsgrad=True)
    with pytest.raises(NotImplementedError, match="schedulers"):
        optimizer.AdamW(learning_rate=lambda: 1e-3,
                        parameters=m.parameters())
    with pytest.raises(NotImplementedError, match="L2"):
        optimizer.Adam(parameters=m.parameters(), weight_decay=0.01)
    with pytest.raises(NotImplementedError, match="groups"):
        optimizer.AdamW(parameters=[{"params": list(m.parameters())}])


def test_default_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: device=None is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTForPretraining(gpt_config("tiny"))
