"""The softmax cross-entropy of the PyTorch port (K8a/K8b) held against
the JAX package on the CPU: the port's ``reference_softmax_ce`` and its
``softmax_ce`` wrapper (which takes the plain version on a CPU tensor)
against the JAX Pallas ``softmax_ce_pallas`` run as the JAX tests run it
(interpret mode) and against the JAX ``reference_softmax_ce``, on the same
numpy inputs; then the port's ``nn.functional.cross_entropy`` against the
JAX ``F.cross_entropy`` with the kernel flag on (interpret) and off.

Tolerances: the loss rtol = atol = 1e-6 and dx rtol 1e-5, atol 1e-6 in
fp32 (the same logsumexp, summed in another order by XLA and torch);
bf16 logits 2e-2 (read as fp32 on both sides; the gradient rounds to
bf16 once, from fp32 values a few ulps apart); ignored rows are exactly
0 in both passes.  A label outside ``[0, V)`` that is not ignored is held
against the Pallas kernel only (no column picked: loss = lse, dx =
softmax · g); the JAX plain version gathers out of bounds there.

The shapes are the JAX kernel test's (ragged rows, wide, odd vocabulary)
and share one JAX compilation per shape across the tests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.flags import get_flags, set_flags
from paddle_tpu.ops.pallas import softmax_ce as jce
from paddle_tpu_torch.nn import functional as tF
from paddle_tpu_torch.ops import softmax_ce as tce

LOSS_TOL = 1e-6
DX_RTOL, DX_ATOL = 1e-5, 1e-6
BF16_TOL = 2e-2

# name: (N, V); rows 0 and 5 (where present) are ignored
SHAPES = {"ragged-rows": (33, 512), "wide": (8, 1024), "odd-vocab": (5, 37)}


def _case(name, seed=0, out_of_range=False):
    n, v = SHAPES[name]
    rs = np.random.RandomState(seed)
    x = rs.randn(n, v).astype(np.float32)
    lab = rs.randint(0, v, n).astype(np.int64)
    g = rs.randn(n).astype(np.float32)
    lab[0] = -100
    if n > 5:
        lab[5] = -100
    if out_of_range:
        lab[1] = v + 3              # not ignored, outside [0, V)
        lab[-1] = -7
    return x, lab, g


def _jax_kernel(x, lab, g, dtype=jnp.float32):
    """The Pallas kernels in interpret mode: per-row loss and dx for the
    per-row upstream gradient g."""
    xj = jnp.asarray(x).astype(dtype)
    loss, vjp = jax.vjp(
        lambda a: jce.softmax_ce_pallas(a, jnp.asarray(lab, jnp.int32),
                                        -100, 16, True), xj)
    (dx,) = vjp(jnp.asarray(g))
    return (np.asarray(loss, np.float32),
            np.asarray(jnp.asarray(dx, jnp.float32)))


def _jax_reference(x, lab, g):
    xj = jnp.asarray(x)
    loss, vjp = jax.vjp(
        lambda a: jce.reference_softmax_ce(a, jnp.asarray(lab, jnp.int32),
                                           -100), xj)
    (dx,) = vjp(jnp.asarray(g))
    return np.asarray(loss), np.asarray(dx)


def _port(fn, x, lab, g, dtype=torch.float32):
    xt = torch.tensor(x).to(dtype).requires_grad_()
    loss = fn(xt, torch.tensor(lab), -100)
    (dx,) = torch.autograd.grad(loss, xt, torch.tensor(g))
    assert loss.dtype == torch.float32 and dx.dtype == dtype
    return loss.detach().numpy(), dx.float().numpy()


def _assert_close(got, want, lab):
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_TOL,
                               atol=LOSS_TOL, err_msg="loss")
    np.testing.assert_allclose(got[1], want[1], rtol=DX_RTOL,
                               atol=DX_ATOL, err_msg="dx")
    ignored = lab == -100
    assert ignored.any()
    assert (got[0][ignored] == 0).all() and (got[1][ignored] == 0).all()


@pytest.mark.parametrize("fn", ["reference_softmax_ce", "softmax_ce"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_port_matches_jax_kernel_and_reference(name, fn):
    """Loss and dx of the port's plain version and of its wrapper on the
    CPU against the Pallas kernels (interpret) and the JAX plain
    version."""
    x, lab, g = _case(name)
    got = _port(getattr(tce, fn), x, lab, g)
    _assert_close(got, _jax_kernel(x, lab, g), lab)
    _assert_close(got, _jax_reference(x, lab, g), lab)


@pytest.mark.parametrize("name", list(SHAPES))
def test_out_of_range_label_matches_jax_kernel(name):
    """A label outside [0, V) that is not ignore_index: no column picked,
    loss = lse and dx = softmax · g, as the Pallas kernel computes."""
    x, lab, g = _case(name, seed=1, out_of_range=True)
    got = _port(tce.softmax_ce, x, lab, g)
    _assert_close(got, _jax_kernel(x, lab, g), lab)
    lse = torch.logsumexp(torch.tensor(x), -1).numpy()
    np.testing.assert_allclose(got[0][[1, -1]], lse[[1, -1]],
                               rtol=LOSS_TOL, atol=LOSS_TOL)


def test_bf16_logits_match_jax_kernel():
    x, lab, g = _case("ragged-rows", seed=3)
    got = _port(tce.softmax_ce, x, lab, g, torch.bfloat16)
    want = _jax_kernel(x, lab, g, jnp.bfloat16)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=BF16_TOL, atol=BF16_TOL)
    assert (got[1][lab == -100] == 0).all()


def test_cuda_route_has_no_cpu_fallback():
    """A tensor off the CPU takes the kernel route, which raises on a
    device it cannot launch on instead of running the plain version."""
    x = torch.empty(4, 7, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tce.softmax_ce(x, torch.zeros(4, dtype=torch.long, device="meta"))


# ---------------------------------------------------------------------------
# nn.functional.cross_entropy: reductions, against the JAX route with the
# kernel on (interpret) and off
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ce_batch():
    rs = np.random.RandomState(2)
    logits = rs.randn(6, 7, 33).astype(np.float32)
    labels = rs.randint(0, 33, (6, 7)).astype(np.int64)
    labels[0, :3] = -100
    labels[4, 6] = -100
    return logits, labels


def _jax_ce(logits, labels, reduction, kernel_on):
    keep = get_flags(["FLAGS_pallas_interpret",
                      "FLAGS_use_pallas_softmax_ce"])
    set_flags({"FLAGS_pallas_interpret": kernel_on,
               "FLAGS_use_pallas_softmax_ce": kernel_on})
    try:
        x = Tensor(logits)
        x.stop_gradient = False
        loss = paddle.nn.functional.cross_entropy(
            x, Tensor(labels), ignore_index=-100, reduction=reduction)
        loss.sum().backward()
        return np.asarray(loss.numpy()), np.asarray(x.grad.numpy())
    finally:
        set_flags(keep)


@pytest.mark.parametrize("kernel_on", [True, False], ids=["kernel", "jnp"])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_matches_jax(ce_batch, reduction, kernel_on):
    logits, labels = ce_batch
    want_loss, want_dx = _jax_ce(logits, labels, reduction, kernel_on)
    x = torch.tensor(logits).requires_grad_()
    loss = tF.cross_entropy(x, torch.tensor(labels), ignore_index=-100,
                            reduction=reduction)
    loss.sum().backward()
    assert tuple(loss.shape) == want_loss.shape
    np.testing.assert_allclose(loss.detach().numpy(), want_loss,
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    np.testing.assert_allclose(x.grad.numpy(), want_dx, rtol=DX_RTOL,
                               atol=DX_ATOL)
    assert (x.grad.numpy()[labels == -100] == 0).all()


def test_cross_entropy_all_ignored_is_zero():
    """Every label ignored: the mean's count clamps at 1e-12, so the loss
    and the gradient are exactly 0, in both packages."""
    logits = np.random.RandomState(4).randn(3, 9).astype(np.float32)
    labels = np.full(3, -100, np.int64)
    want_loss, want_dx = _jax_ce(logits, labels, "mean", True)
    x = torch.tensor(logits).requires_grad_()
    loss = tF.cross_entropy(x, torch.tensor(labels))
    loss.backward()
    assert float(loss.detach()) == float(want_loss) == 0.0
    assert (x.grad == 0).all() and (want_dx == 0).all()


def test_vocab_sharded_takes_the_log_softmax_route(ce_batch, monkeypatch):
    """``_vocab_sharded`` keeps the loss off K8 (the GPT and LLaMA
    criteria's route), with the same numbers."""
    logits, labels = ce_batch

    def no_kernel(*a, **k):
        raise AssertionError("K8 taken under _vocab_sharded")

    x, lab = torch.tensor(logits), torch.tensor(labels)
    want = tF.cross_entropy(x, lab, reduction="none")
    monkeypatch.setattr(tF, "_softmax_ce_op", no_kernel)
    got = tF.cross_entropy(x, lab, reduction="none", _vocab_sharded=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
