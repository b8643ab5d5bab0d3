"""Signatures and defaults of the port's ``nn.functional`` against the
JAX package's: each op takes the reference's parameters, in its order,
with its defaults (read with ``inspect.signature``); the port may add
keyword-only parameters after them (``generator``).  Then the behaviour
each repaired signature implies: ``cross_entropy`` reduces to a scalar
mean by default, ``dropout``'s third positional parameter is ``axis``,
``matmul``'s is ``transpose_x``, and an ``attn_mask`` given to
``scaled_dot_product_attention`` raises until a slice supports it.
"""
import inspect

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import functional as jF
from paddle_tpu_torch.nn import functional as tF

# port name: the reference function
REFERENCE = {
    "cross_entropy": jF.cross_entropy,
    "dropout": jF.dropout,
    "matmul": paddle.matmul,
    "scaled_dot_product_attention": jF.scaled_dot_product_attention,
    "softmax": jF.softmax,
    "relu": jF.relu,
    "linear": jF.linear,
    "gelu": jF.gelu,
    "silu": jF.silu,
    "layer_norm": jF.layer_norm,
}


def _positional(fn):
    return [(p.name, p.default) for p in
            inspect.signature(fn).parameters.values()
            if p.kind is not inspect.Parameter.KEYWORD_ONLY]


@pytest.mark.parametrize("name", list(REFERENCE))
def test_signature_matches_reference(name):
    assert _positional(getattr(tF, name)) == _positional(REFERENCE[name])


def test_cross_entropy_defaults_to_a_scalar_mean():
    rs = np.random.RandomState(0)
    x = torch.tensor(rs.randn(5, 11).astype(np.float32))
    lab = torch.tensor(rs.randint(0, 11, 5))
    lab[2] = -100
    loss = tF.cross_entropy(x, lab)
    per = tF.cross_entropy(x, lab, reduction="none")
    assert loss.dim() == 0
    torch.testing.assert_close(loss, per.sum() / 4, rtol=1e-6, atol=1e-6)


def test_dropout_third_positional_is_axis():
    """``dropout(x, 0.5, None)``: axis None, training stays True, so
    elements drop (and the kept ones scale by 2)."""
    x = torch.ones(4096)
    y = tF.dropout(x, 0.5, None, generator=torch.Generator().manual_seed(0))
    assert (y == 0).any() and set(y.unique().tolist()) == {0.0, 2.0}
    assert torch.equal(tF.dropout(x, 0.5, None, False), x)
    with pytest.raises(NotImplementedError):
        tF.dropout(x, 0.5, 0)
    with pytest.raises(NotImplementedError):
        tF.dropout(x, 0.5, mode="downscale_in_infer")


def test_matmul_third_positional_is_transpose_x():
    rs = np.random.RandomState(1)
    x = torch.tensor(rs.randn(3, 5).astype(np.float32))
    y = torch.tensor(rs.randn(3, 4).astype(np.float32))
    torch.testing.assert_close(tF.matmul(x, y, True), x.t() @ y)
    z = torch.tensor(rs.randn(4, 5).astype(np.float32))
    torch.testing.assert_close(tF.matmul(x, z, False, True), x @ z.t())


def test_sdpa_attn_mask_raises():
    q = torch.zeros(1, 4, 2, 8)
    mask = torch.zeros(1, 2, 4, 4)
    with pytest.raises(NotImplementedError):
        tF.scaled_dot_product_attention(q, q, q, mask)


def test_softmax_matches_reference():
    from paddle_tpu.core.tensor import Tensor
    x = np.random.RandomState(2).randn(3, 7).astype(np.float32)
    want = np.asarray(jF.softmax(Tensor(x), axis=0).numpy())
    got = tF.softmax(torch.tensor(x), axis=0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert tF.softmax(torch.tensor(x), dtype="float64").dtype \
        == torch.float64


@pytest.mark.parametrize("name", ["linear", "gelu", "silu", "layer_norm"])
def test_trailing_name_is_taken_and_ignored(name):
    """``name`` is a label: the result equals the call without it."""
    rs = np.random.RandomState(0)
    x = torch.tensor(rs.randn(3, 4).astype(np.float32))
    w = torch.tensor(rs.randn(4, 5).astype(np.float32))
    args = {"linear": (x, w, None), "gelu": (x, False), "silu": (x,),
            "layer_norm": (x, 4, None, None, 1e-5)}[name]
    fn = getattr(tF, name)
    assert torch.equal(fn(*args, name="op"), fn(*args))
