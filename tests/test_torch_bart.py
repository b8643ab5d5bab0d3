"""The PyTorch port's BART slice held against the JAX package on the CPU,
at the tiny config of ``tests/test_bart.py`` (vocab 64, d_model 32, 2 + 2
layers, 4 heads, FFN 64).  Both packages get the same weights: a JAX
model's parameters are set from a numpy seed (embeddings std 0.3,
matrices 2 / sqrt(fan_in), so that greedy and beam search pick varied
tokens: at smaller gains the tied head repeats one token) and carried
into the port by name (``models.carry``).  The batch pads the tail of one encoder row (mask 0)
and ignores label positions (-100).

Tolerances (fp32: the same math, summed in other orders by XLA and
torch): logits 2e-5; the loss 1e-5; every gradient by name atol 2e-5
(gradients of order 1); a three-step AdamW loss curve 1e-5, with
``final_logits_bias`` left exactly at 0 (it is frozen); greedy and
3-beam ``generate`` tokens identical.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models.bart import BartConfig as JaxConfig
from paddle_tpu.models.bart import BartForConditionalGeneration as JaxBart

from paddle_tpu_torch import optimizer
from paddle_tpu_torch.jit import train_step
from paddle_tpu_torch.models import (BartConfig, BartForConditionalGeneration,
                                     load_paddle_tpu_state)

TINY = dict(vocab_size=64, d_model=32, encoder_layers=2, decoder_layers=2,
            encoder_attention_heads=4, decoder_attention_heads=4,
            encoder_ffn_dim=64, decoder_ffn_dim=64,
            max_position_embeddings=64)
LOGITS_TOL = 2e-5
LOSS_TOL = 1e-5
GRAD_TOL = 2e-5
LR = 1e-3


def _pair(zero_bias=False):
    """A JAX BART with numpy-seeded weights and the port's with the same
    weights."""
    paddle.seed(0)
    jm = JaxBart(JaxConfig(**TINY))
    rs = np.random.RandomState(0)
    for name, p in jm.state_dict().items():
        shape = tuple(p.shape)
        if "norm" in name and name.endswith(".weight"):
            val = 1.0 + 0.1 * rs.randn(*shape)
        elif "embed" in name or name == "shared.weight":
            val = 0.3 * rs.randn(*shape)
        elif len(shape) == 2:                        # [in, out]
            val = 2.0 * rs.randn(*shape) / np.sqrt(shape[0])
        elif name == "final_logits_bias":
            val = np.zeros(shape) if zero_bias else 0.1 * rs.randn(*shape)
        else:
            val = 0.02 * rs.randn(*shape)
        p.set_value(val.astype(np.float32))
    arrays = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    pm = BartForConditionalGeneration(BartConfig(**TINY), device="cpu")
    load_paddle_tpu_state(pm, arrays)
    return jm, pm


def _batch(b=2, s_enc=10, s_dec=6, seed=0):
    rs = np.random.RandomState(seed)
    enc = rs.randint(3, 64, (b, s_enc)).astype(np.int64)
    mask = np.ones((b, s_enc), np.int64)
    mask[1, 7:] = 0
    enc[1, 7:] = 1
    dec = rs.randint(3, 64, (b, s_dec)).astype(np.int64)
    labels = rs.randint(3, 64, (b, s_dec)).astype(np.int64)
    labels[1, 4:] = -100
    return enc, mask, dec, labels


@pytest.fixture(scope="module")
def pair():
    return _pair()


def test_names_match_the_jax_state_dict():
    """The shared embedding appears once, as shared.weight, and the frozen
    bias is a parameter: 50 names at 1 + 1 layers, as in the JAX model."""
    paddle.seed(0)
    cfg = dict(TINY, encoder_layers=1, decoder_layers=1)
    names = set(JaxBart(JaxConfig(**cfg)).state_dict())
    pm = BartForConditionalGeneration(BartConfig(**cfg), device="cpu")
    got = dict(pm.named_parameters())
    assert len(names) == 50 and set(got) == names
    assert not got["final_logits_bias"].requires_grad


def test_logits_loss_and_gradients_match_jax(pair):
    jm, pm = pair
    enc, mask, dec, labels = _batch()
    jm.train()
    jlogits = jm(Tensor(enc), Tensor(dec), attention_mask=Tensor(mask))
    jloss = jm.loss_fn(jlogits, Tensor(labels))
    jloss.backward()
    jgrads = {n: np.asarray(p.grad.numpy())
              for n, p in jm.named_parameters() if p.grad is not None}
    jm.clear_gradients()
    pm.train()
    plogits = pm(torch.tensor(enc), torch.tensor(dec),
                 attention_mask=torch.tensor(mask))
    ploss = pm.loss_fn(plogits, torch.tensor(labels))
    ploss.backward()
    np.testing.assert_allclose(plogits.detach().numpy(),
                               np.asarray(jlogits.numpy()), rtol=LOGITS_TOL,
                               atol=LOGITS_TOL)
    np.testing.assert_allclose(float(ploss.detach()), float(jloss),
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    pgrads = {n: p.grad for n, p in pm.named_parameters()}
    assert pgrads.pop("final_logits_bias") is None
    assert set(pgrads) == set(jgrads)
    for n, g in pgrads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[n], rtol=0,
                                   atol=GRAD_TOL, err_msg=n)
    pm.zero_grad(set_to_none=True)
    pm.eval()


def test_eval_logits_with_padded_mask_match_jax(pair):
    jm, pm = pair
    enc, mask, dec, _ = _batch(seed=1)
    jm.eval()
    want = np.asarray(jm(Tensor(enc), Tensor(dec),
                         attention_mask=Tensor(mask)).numpy())
    got = pm(torch.tensor(enc), torch.tensor(dec),
             attention_mask=torch.tensor(mask))
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=LOGITS_TOL,
                               atol=LOGITS_TOL)


def test_adamw_loss_curve_matches_jax():
    """Three AdamW steps (lr 1e-3, weight decay 0.01): the JAX model's
    eager loop against the port's ``jit.train_step``."""
    jm, pm = _pair(zero_bias=True)
    enc, mask, dec, labels = _batch(b=4, seed=2)
    jo = jopt.AdamW(learning_rate=LR, parameters=jm.parameters(),
                    weight_decay=0.01)
    jm.train()
    jl = []
    for _ in range(3):
        loss = jm.loss_fn(jm(Tensor(enc), Tensor(dec),
                             attention_mask=Tensor(mask)), Tensor(labels))
        loss.backward()
        jo.step()
        jo.clear_grad()
        jl.append(float(loss))
    po = optimizer.AdamW(learning_rate=LR, parameters=pm.parameters(),
                         weight_decay=0.01)

    def step_fn(m, e, d, msk, lab):
        return m.loss_fn(m(e, d, attention_mask=msk), lab)

    step = train_step(pm, None, po, step_fn=step_fn)
    pl = [float(step(enc, dec, mask, labels)) for _ in range(3)]
    np.testing.assert_allclose(pl, jl, rtol=0, atol=LOSS_TOL)
    assert pl[-1] < pl[0]
    assert float(torch.abs(pm.final_logits_bias).sum()) == 0.0
    assert float(paddle.abs(jm.final_logits_bias).sum()) == 0.0


@pytest.mark.parametrize("num_beams", [1, 3], ids=["greedy", "beam3"])
def test_generate_tokens_match_jax(pair, num_beams):
    jm, pm = pair
    enc, mask, _, _ = _batch(seed=3)
    jm.eval()
    want = np.asarray(jm.generate(Tensor(enc), attention_mask=Tensor(mask),
                                  max_new_tokens=8,
                                  num_beams=num_beams).numpy())
    got = pm.generate(torch.tensor(enc), attention_mask=torch.tensor(mask),
                      max_new_tokens=8, num_beams=num_beams).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(set(got[:, 1:-1].ravel().tolist())) > 2   # varied tokens
    assert (got[:, -1] == 2).all()                # the forced eos fired
