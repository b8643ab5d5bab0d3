"""The port's activation recompute (``distributed.fleet.recompute``) held
against the JAX package's on the CPU: the same numpy inputs and weights
go through ``fleet.recompute``, ``recompute_sequential`` and
``recompute_hybrid`` of each package, and through the tiny GPT and
LLaMA with ``use_recompute=True``.  Outputs, the input's gradient and
every parameter's gradient agree to fp32 2e-5 (the same math in another
summation order).  Within the port, recompute with dropout on equals the
plain run bit for bit: the recomputation replays the forward's dropout
bits from the model's generator.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.models.gpt import gpt_config as jax_gpt_config
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_config as jax_llama_config

from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.models import (GPTForPretraining, LlamaForCausalLM,
                                     gpt_config, llama_config,
                                     load_paddle_tpu_state)

TOL = 2e-5
WIDTHS = (6, 16, 8, 12, 5)          # the sequential stack's widths


def _weights(seed, widths=WIDTHS):
    rs = np.random.RandomState(seed)
    return [((rs.randn(a, b) / np.sqrt(a)).astype(np.float32),
             (rs.randn(b) * 0.1).astype(np.float32))
            for a, b in zip(widths[:-1], widths[1:])]


def _inputs(seed, rows=7, width=WIDTHS[0], out=WIDTHS[-1]):
    rs = np.random.RandomState(seed)
    return (rs.randn(rows, width).astype(np.float32),
            rs.randn(rows, out).astype(np.float32))


class _Linear(torch.nn.Module):
    """``x @ w + b`` with the Paddle ``[in, out]`` weight."""

    def __init__(self, w, b):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.tensor(w))
        self.bias = torch.nn.Parameter(torch.tensor(b))

    def forward(self, x):
        return x @ self.weight + self.bias


def _jax_linear(w, b):
    lin = jnn.Linear(*w.shape)
    lin.weight.set_value(w)
    lin.bias.set_value(b)
    return lin


def _port_stack(weights):
    layers = []
    for i, (w, b) in enumerate(weights):
        layers.append(_Linear(w, b))
        if i < len(weights) - 1:
            layers.append(torch.nn.GELU() if i % 2 == 0 else torch.nn.Tanh())
    return torch.nn.Sequential(*layers)


def _jax_stack(weights):
    layers = []
    for i, (w, b) in enumerate(weights):
        layers.append(_jax_linear(w, b))
        if i < len(weights) - 1:
            layers.append(jnn.GELU() if i % 2 == 0 else jnn.Tanh())
    return jnn.Sequential(*layers)


def _port_run(stack, x_np, cot, call):
    x = torch.tensor(x_np, requires_grad=True)
    y = call(stack, x)
    (y * torch.tensor(cot)).sum().backward()
    return (y.detach().numpy(), x.grad.numpy(),
            [p.grad.numpy() for p in stack.parameters()])


def _jax_run(stack, x_np, cot, call):
    x = paddle.to_tensor(x_np, stop_gradient=False)
    y = call(stack, x)
    (y * paddle.to_tensor(cot)).sum().backward()
    return (y.numpy(), x.grad.numpy(),
            [p.grad.numpy() for p in stack.parameters()])


def _assert_same(got, want):
    (y, dx, dps), (wy, wdx, wdps) = got, want
    np.testing.assert_allclose(y, wy, rtol=0, atol=TOL)
    np.testing.assert_allclose(dx, wdx, rtol=0, atol=TOL)
    assert len(dps) == len(wdps)
    for a, b in zip(dps, wdps):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)


def test_recompute_of_a_closure_matches_jax():
    """A two-layer Linear-GELU-Linear closure: the output, the explicit
    input's gradient and the captured parameters' gradients."""
    (w1, b1), (w2, b2) = _weights(0, (6, 16, 5))
    x, cot = _inputs(1)
    p1, p2 = _Linear(w1, b1), _Linear(w2, b2)
    j1, j2 = _jax_linear(w1, b1), _jax_linear(w2, b2)
    port = torch.nn.ModuleList([p1, p2])
    jax = jnn.LayerList([j1, j2])
    got = _port_run(port, x, cot, lambda _, t: fleet.recompute(
        lambda v: p2(torch.nn.functional.gelu(p1(v))), t))
    want = _jax_run(jax, x, cot, lambda _, t: jfleet.recompute(
        lambda v: j2(jnn.functional.gelu(j1(v))), t))
    _assert_same(got, want)
    plain = _port_run(port.__class__([_Linear(w1, b1), _Linear(w2, b2)]),
                      x, cot, lambda m, t: m[1](
                          torch.nn.functional.gelu(m[0](t))))
    _assert_same(got, plain)


@pytest.mark.parametrize("use_reentrant", [True, False])
def test_recompute_fills_closure_gradients_without_an_input_gradient(
        use_reentrant):
    """No explicit input requires a gradient: the closure's parameters
    still get theirs (torch's reentrant form would leave them None),
    equal to the JAX package's (whose output needs an input that
    requires a gradient to be differentiable at all)."""
    (w1, b1), (w2, b2) = _weights(2, (6, 16, 5))
    x, cot = _inputs(3)
    p1, p2 = _Linear(w1, b1), _Linear(w2, b2)
    y = fleet.recompute(lambda v: p2(torch.nn.functional.gelu(p1(v))),
                        torch.tensor(x), use_reentrant=use_reentrant)
    (y * torch.tensor(cot)).sum().backward()
    j1, j2 = _jax_linear(w1, b1), _jax_linear(w2, b2)
    jy = jfleet.recompute(lambda v: j2(jnn.functional.gelu(j1(v))),
                          paddle.to_tensor(x, stop_gradient=False))
    (jy * paddle.to_tensor(cot)).sum().backward()
    for p, j in zip((p1.weight, p1.bias, p2.weight, p2.bias),
                    (j1.weight, j1.bias, j2.weight, j2.bias)):
        np.testing.assert_allclose(p.grad.numpy(), j.grad.numpy(), rtol=0,
                                   atol=TOL)


@pytest.mark.parametrize("segments", [1, 2, 3])
def test_recompute_sequential_matches_jax(segments):
    weights = _weights(4)
    x, cot = _inputs(5)
    ctx = {"segments": segments, "preserve_rng_state": True}
    got = _port_run(_port_stack(weights), x, cot,
                    lambda m, t: fleet.recompute_sequential(ctx, m, t))
    want = _jax_run(_jax_stack(weights), x, cot,
                    lambda m, t: jfleet.recompute_sequential(ctx, m, t))
    _assert_same(got, want)


def test_recompute_hybrid_matches_jax():
    weights = _weights(6)
    x, cot = _inputs(7)
    ctx = {"mp_group": None, "offload": False, "partition": False}
    got = _port_run(_port_stack(weights), x, cot,
                    lambda m, t: fleet.recompute_hybrid(
                        ctx, m, t, offload_indices=[0]))
    want = _jax_run(_jax_stack(weights), x, cot,
                    lambda m, t: jfleet.recompute_hybrid(
                        ctx, m, t, offload_indices=[0]))
    _assert_same(got, want)


def test_fleet_utils_reexports_recompute():
    from paddle_tpu_torch.distributed.fleet import utils
    from paddle_tpu_torch.distributed.fleet.recompute import recompute
    assert utils.recompute is recompute is fleet.recompute


def _batch(vocab, seed=0, b=2, s=16):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, vocab, (b, s)).astype(np.int64)
    labels = rs.randint(0, vocab, (b, s)).astype(np.int64)
    labels[0, :3] = -100
    return ids, labels


MODELS = {
    "gpt": (JaxGPT, jax_gpt_config, GPTForPretraining, gpt_config,
            dict(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)),
    "llama": (JaxLlama, jax_llama_config, LlamaForCausalLM, llama_config,
              {}),
}


@pytest.mark.parametrize("name", list(MODELS))
def test_use_recompute_model_matches_jax(name):
    """The tiny model with ``use_recompute=True`` in both packages (the
    JAX weights carried over): the loss and every parameter's
    gradient."""
    jcls, jcfg, pcls, pcfg, kw = MODELS[name]
    paddle.seed(0)
    jm = jcls(jcfg("tiny", use_recompute=True, **kw))
    arrays = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    pm = pcls(pcfg("tiny", use_recompute=True, **kw), device="cpu")
    load_paddle_tpu_state(pm, arrays)
    ids, labels = _batch(pm.config.vocab_size)
    jm.train()
    jloss = jm.loss_fn(jm(paddle.to_tensor(ids)), paddle.to_tensor(labels))
    jloss.backward()
    pm.train()
    ploss = pm.loss_fn(pm(torch.from_numpy(ids)), torch.from_numpy(labels))
    ploss.backward()
    np.testing.assert_allclose(ploss.item(), float(jloss), rtol=0,
                               atol=TOL)
    jgrads = {n: p.grad.numpy() for n, p in jm.named_parameters()}
    pgrads = dict(pm.named_parameters())
    assert set(jgrads) == set(pgrads)
    for n, g in jgrads.items():
        np.testing.assert_allclose(pgrads[n].grad.numpy(), g, rtol=0,
                                   atol=TOL, err_msg=n)


@pytest.mark.parametrize("name", ["gpt", "llama"])
def test_recompute_with_dropout_is_bit_equal_to_the_plain_run(name):
    """GPT with dropout on (hidden and attention): the recomputed backward
    replays the forward's bits, so the loss and every gradient equal the
    plain run's exactly, and the generator ends where the plain run left
    it.  LLaMA (no dropout) equals its plain run too."""
    _, _, pcls, pcfg, _ = MODELS[name]
    kw = dict(hidden_dropout_prob=0.2, attention_dropout_prob=0.2) \
        if name == "gpt" else {}
    out = []
    for use in (False, True):
        m = pcls(pcfg("tiny", use_recompute=use, **kw), device="cpu",
                 seed=11).train()
        ids, labels = _batch(m.config.vocab_size, seed=3)
        loss = m.loss_fn(m(torch.from_numpy(ids)), torch.from_numpy(labels))
        loss.backward()
        out.append((loss.detach(), {n: p.grad for n, p in
                                    m.named_parameters()},
                    m.generator.get_state()))
    (l0, g0, s0), (l1, g1, s1) = out
    assert torch.equal(l0, l1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    assert torch.equal(s0, s1)


def test_recompute_replays_an_explicit_generator():
    """``generator=``: the recomputation runs from the forward's starting
    state and hands the generator back where it was."""
    g = torch.Generator().manual_seed(5)
    w = torch.nn.Parameter(torch.randn(8, 8, generator=g))

    def fn(x):
        return _drop(x @ w, g)

    x = torch.randn(4, 8, generator=torch.Generator().manual_seed(6))
    g.manual_seed(9)
    (fn(x) ** 2).sum().backward()
    want = w.grad.clone()
    w.grad = None
    g.manual_seed(9)
    (fleet.recompute(fn, x, generator=g) ** 2).sum().backward()
    assert torch.equal(w.grad, want)
    g2 = torch.Generator().manual_seed(9)
    _drop(x, g2)
    assert torch.equal(g.get_state(), g2.get_state())


def _drop(x, g, p=0.5):
    keep = torch.rand(x.shape, generator=g) >= p
    return x * keep / (1 - p)


@pytest.mark.parametrize("name", ["gpt", "llama"])
def test_recompute_under_o2_replays_the_amp_state(name):
    """amp O2: the forward runs inside ``amp.auto_cast`` and the backward
    outside it, so the recomputation must run under the forward's amp
    state (the port's amp is a module state that torch's checkpoint does
    not carry); the loss and every gradient then equal the plain O2
    run's bit for bit."""
    from paddle_tpu_torch import amp
    _, _, pcls, pcfg, kw = MODELS[name]
    out = []
    for use in (False, True):
        m = pcls(pcfg("tiny", use_recompute=use, **kw), device="cpu",
                 seed=13)
        m = amp.decorate(models=m, level="O2", dtype="bfloat16").train()
        ids, labels = _batch(m.config.vocab_size, seed=4)
        with amp.auto_cast(enable=True, level="O2", dtype="bfloat16"):
            loss = m.loss_fn(m(torch.from_numpy(ids)),
                             torch.from_numpy(labels))
        loss.backward()
        out.append((loss.detach(), {n: p.grad for n, p in
                                    m.named_parameters()}))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
