"""The training kernels of the PyTorch port (flash attention K1, LayerNorm
K2, fused AdamW K3) held against the JAX package on the CPU: each
module's plain version — what the wrapper runs on a CPU tensor — against
the JAX kernels run as the JAX tests run them (Pallas interpret mode), on
the same numpy inputs.  Gradients: torch autograd through the port's
plain version against ``jax.vjp`` through the JAX ``custom_vjp`` (the
hand-written flash and LayerNorm backward kernels).

Tolerances, all stated per test:
* fp32: 2e-5 for attention and LayerNorm outputs and gradients (the same
  math summed in other orders: the Pallas kernels' blockwise online
  softmax and row-block reductions vs torch's two-pass einsum/softmax);
* bf16: 2e-2, one bf16 rounding step of values below 4, compared in
  fp32 (both sides round their bf16 outputs once, from fp32 sums that
  differ by a few ulps);
* AdamW: rtol 1e-6, atol 1e-7 (one fp32 ulp of values of order 1: the
  port rounds ``(1 - b2) * (g * g)`` as the unfused JAX sequence does,
  the TPU kernel ``((1 - b2) * g) * g``, and XLA may order the rest of
  the arithmetic otherwise; where an update nearly cancels p, that ulp
  of the inputs is a larger share of the small result).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.flags import get_flags, set_flags
from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu.ops.pallas import fused_adamw as jadamw
from paddle_tpu.ops.pallas import layer_norm as jln
from paddle_tpu_torch.nn import functional as tF
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import fused_adamw as tadamw
from paddle_tpu_torch.ops import layer_norm as tln

F32_TOL = 2e-5
BF16_TOL = 2e-2


def _t(a, dtype=torch.float32, grad=False):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype) \
        .requires_grad_(grad)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture
def interpret():
    keep = get_flags(["FLAGS_pallas_interpret"])
    set_flags({"FLAGS_pallas_interpret": True})
    yield
    set_flags(keep)


# ---------------------------------------------------------------------------
# K1: flash attention
# ---------------------------------------------------------------------------

# (causal, bh, sq, sk, d, n_rep): self-attention causal and not, a decode
# chunk (sq < sk, q_offset = sk - sq) and GQA with two q heads per kv head
FLASH_CASES = {
    "causal": (True, 4, 32, 32, 16, 1),
    "full": (False, 4, 32, 32, 16, 1),
    "q_offset": (True, 4, 16, 48, 16, 1),
    "gqa": (True, 4, 32, 32, 16, 2),
}


def _flash_inputs(case, seed=0, cases=FLASH_CASES):
    causal, bh, sq, sk, d, n_rep = cases[case]
    rs = np.random.RandomState(seed)
    q = rs.randn(bh, sq, d).astype(np.float32)
    k = rs.randn(bh // n_rep, sk, d).astype(np.float32)
    v = rs.randn(bh // n_rep, sk, d).astype(np.float32)
    do = rs.randn(bh, sq, d).astype(np.float32)
    return (q, k, v, do), dict(scale=1.0 / np.sqrt(d), causal=causal,
                               q_offset=sk - sq if causal else 0,
                               n_rep=n_rep)


def _jax_flash(arrs, kw, dtype):
    q, k, v, do = (_j(a, dtype) for a in arrs)

    def f(q, k, v):
        return jfa.flash_attention_bhsd(q, k, v, kw["scale"], kw["causal"],
                                        16, 16, True, kw["q_offset"],
                                        kw["n_rep"])
    out, vjp = jax.vjp(f, q, k, v)
    return (out,) + tuple(vjp(do))


def _port_flash(arrs, kw, dtype):
    q, k, v = (_t(a, dtype, grad=True) for a in arrs[:3])
    out = tfa.flash_attention_bhsd(q, k, v, kw["scale"], kw["causal"],
                                   q_offset=kw["q_offset"],
                                   n_rep=kw["n_rep"])
    grads = torch.autograd.grad(out, (q, k, v), _t(arrs[3], dtype))
    return (out,) + grads


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_plain_matches_jax_kernel_fp32(case):
    """fp32, tolerance F32_TOL: out, dq, dk, dv."""
    arrs, kw = _flash_inputs(case)
    want = _jax_flash(arrs, kw, jnp.float32)
    got = _port_flash(arrs, kw, torch.float32)
    for name, w, g in zip(("out", "dq", "dk", "dv"), want, got):
        np.testing.assert_allclose(_np(g), _np(w), rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=name)


def test_flash_plain_matches_jax_kernel_bf16():
    """bf16 causal GQA, tolerance BF16_TOL in fp32: out and gradients."""
    arrs, kw = _flash_inputs("gqa", seed=1)
    want = _jax_flash(arrs, kw, jnp.bfloat16)
    got = _port_flash(arrs, kw, torch.bfloat16)
    for name, w, g in zip(("out", "dq", "dk", "dv"), want, got):
        assert g.dtype == torch.bfloat16, name
        np.testing.assert_allclose(_np(g), _np(w), rtol=BF16_TOL,
                                   atol=BF16_TOL, err_msg=name)


# the tensor-core backward's cases: FLASH_CASES and the training paths'
# head_dim at a causal S = 256
ROUNDING_CASES = dict(FLASH_CASES, d128=(True, 2, 256, 256, 128, 1))
# chip_smoke.py's KTOL for bf16 (atol, rtol): the card's kernel check
CARD_BF16_TOL = (2e-2, 1e-2)


def _bf16_operand_backward(arrs, kw):
    """The bf16 backward's roundings on the card, in plain torch: bf16
    inputs, fp32 sums, fp32 P = exp(scale S - LSE) and dS = P o (dP -
    delta), P and dS rounded to bf16 before the products that take them
    (dV = P^T dO, dQ = scale dS K, dK = scale dS^T Q); delta = rowsum(O dO)
    of the bf16 forward output; the GQA group summed in fp32; each
    gradient rounded to bf16 once."""
    q, k, v, do = (_t(a, torch.bfloat16).float() for a in arrs)
    scale, n_rep = kw["scale"], kw["n_rep"]
    k, v = k.repeat_interleave(n_rep, 0), v.repeat_interleave(n_rep, 0)
    s = torch.einsum("bqd,bkd->bqk", q, k) * scale
    if kw["causal"]:
        qi = torch.arange(s.shape[1])[:, None] + kw["q_offset"]
        s = torch.where(qi >= torch.arange(s.shape[2])[None], s,
                        torch.tensor(tfa.NEG_INF))
    p = torch.exp(s - torch.logsumexp(s, -1, keepdim=True))
    out = torch.einsum("bqk,bkd->bqd", p, v).bfloat16().float()
    delta = (out * do).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bqd,bkd->bqk", do, v) - delta)
    pb, dsb = p.bfloat16().float(), ds.bfloat16().float()
    dq = scale * torch.einsum("bqk,bkd->bqd", dsb, k)
    dk = scale * torch.einsum("bqk,bqd->bkd", dsb, q)
    dv = torch.einsum("bqk,bqd->bkd", pb, do)
    group = (-1, n_rep) + tuple(dk.shape[1:])
    return tuple(t.bfloat16() for t in (dq, dk.reshape(group).sum(1),
                                         dv.reshape(group).sum(1)))


@pytest.mark.parametrize("case", list(ROUNDING_CASES))
def test_flash_bf16_operand_roundings_fit_the_tolerances(case):
    """Rounding P and dS to bf16 before their products (the tensor-core
    kernels' operands) keeps the gradients within BF16_TOL of the JAX
    kernels' bf16 gradients (interpret mode) and within the card's bf16
    KTOL of the fp32 plain version on the same bf16 inputs."""
    arrs, kw = _flash_inputs(case, seed=2, cases=ROUNDING_CASES)
    want = _jax_flash(arrs, kw, jnp.bfloat16)[1:]
    got = _bf16_operand_backward(arrs, kw)
    rounded = [_np(_t(a, torch.bfloat16)) for a in arrs]
    plain = _port_flash(rounded, kw, torch.float32)[1:]
    atol, rtol = CARD_BF16_TOL
    for name, g, w, p in zip(("dq", "dk", "dv"), got, want, plain):
        np.testing.assert_allclose(_np(g), _np(w), rtol=BF16_TOL,
                                   atol=BF16_TOL, err_msg=name)
        np.testing.assert_allclose(_np(g), _np(p), rtol=rtol, atol=atol,
                                   err_msg=name)


# the tensor-core forward's key tile
KEY_TILE = 64


def _bf16_operand_forward(arrs, kw):
    """The bf16 forward's roundings on the card, in plain torch: bf16
    inputs, fp32 S = Q K^T with the scale applied to S (not to the bf16
    Q), the fp32 online (m, l) over key tiles of 64, P = exp(S - m)
    carried into P V as two bf16 terms (hi = bf16(P), lo = bf16(P - hi)),
    O = acc / l in fp32 rounded to bf16 once, and the fp32 LSE = m +
    log(l)."""
    q, k, v = (_t(a, torch.bfloat16).float() for a in arrs[:3])
    scale, n_rep = kw["scale"], kw["n_rep"]
    k, v = k.repeat_interleave(n_rep, 0), v.repeat_interleave(n_rep, 0)
    bh, sq, d = q.shape
    sk = k.shape[1]
    m = torch.full((bh, sq, 1), tfa.NEG_INF)
    l = torch.zeros(bh, sq, 1)
    acc = torch.zeros(bh, sq, d)
    qi = torch.arange(sq)[:, None] + kw["q_offset"]
    for k0 in range(0, sk, KEY_TILE):
        s = torch.einsum("bqd,bkd->bqk", q, k[:, k0:k0 + KEY_TILE]) * scale
        seen = torch.ones(sq, s.shape[2], dtype=torch.bool)
        if kw["causal"]:
            seen = qi >= torch.arange(k0, k0 + s.shape[2])[None]
        s = torch.where(seen, s, torch.tensor(tfa.NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(seen, torch.exp(s - m_new), torch.tensor(0.0))
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        lo = (p - hi).bfloat16().float()
        vb = v[:, k0:k0 + KEY_TILE]
        acc = acc * alpha + torch.einsum("bqk,bkd->bqd", hi, vb) \
            + torch.einsum("bqk,bkd->bqd", lo, vb)
        m = m_new
    lc = l.clamp_min(1e-30)
    return (acc / lc).bfloat16(), (m + torch.log(lc))[..., 0]


@pytest.mark.parametrize("case", list(ROUNDING_CASES))
def test_flash_bf16_forward_roundings_fit_the_tolerances(case):
    """The tensor-core forward's roundings (scale on the fp32 S, P in
    two bf16 terms before P V, O cast once) keep O within BF16_TOL of
    the JAX kernel's bf16 output (interpret mode) and within the card's
    bf16 KTOL of the fp32 plain version on the same bf16 inputs; the LSE
    within F32_TOL of both."""
    arrs, kw = _flash_inputs(case, seed=3, cases=ROUNDING_CASES)
    got, got_lse = _bf16_operand_forward(arrs, kw)
    with jax.enable_x64(False):
        want, want_lse = jfa._flash_fwd(
            *(_j(a, jnp.bfloat16) for a in arrs[:3]), kw["scale"],
            kw["causal"], 16, 16, True, kw["q_offset"], kw["n_rep"])
    rounded = [_t(_np(_t(a, torch.bfloat16))) for a in arrs[:3]]
    plain, plain_lse = tfa.reference_attention_bhsd(
        *rounded, kw["scale"], kw["causal"], kw["q_offset"], kw["n_rep"],
        return_lse=True)
    atol, rtol = CARD_BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_TOL,
                               atol=BF16_TOL)
    np.testing.assert_allclose(_np(got), _np(plain), rtol=rtol, atol=atol)
    for other in (want_lse, plain_lse):
        np.testing.assert_allclose(_np(got_lse), _np(other), rtol=F32_TOL,
                                   atol=F32_TOL)


def test_flash_plain_lse_matches_jax_kernel():
    """The fp32 row log-sum-exp (the kernel's second output), F32_TOL."""
    arrs, kw = _flash_inputs("q_offset")
    with jax.enable_x64(False):
        _, want = jfa._flash_fwd(*(_j(a) for a in arrs[:3]), kw["scale"],
                                 kw["causal"], 16, 16, True, kw["q_offset"],
                                 kw["n_rep"])
    _, got = tfa.reference_attention_bhsd(
        *(_t(a) for a in arrs[:3]), kw["scale"], kw["causal"],
        kw["q_offset"], kw["n_rep"], return_lse=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=F32_TOL,
                               atol=F32_TOL)


def test_sdpa_route_matches_jax_functional():
    """``nn.functional.scaled_dot_product_attention`` ([B, S, H, D],
    causal, GQA) against the JAX functional with the Pallas route in
    interpret mode, fp32, F32_TOL."""
    from paddle_tpu.core.tensor import Tensor
    from paddle_tpu.nn import functional as jF
    rs = np.random.RandomState(3)
    q = rs.randn(2, 32, 4, 16).astype(np.float32)
    k = rs.randn(2, 32, 2, 16).astype(np.float32)
    v = rs.randn(2, 32, 2, 16).astype(np.float32)
    keep = get_flags(["FLAGS_pallas_interpret", "FLAGS_pallas_gqa"])
    set_flags({"FLAGS_pallas_interpret": True, "FLAGS_pallas_gqa": True})
    try:
        want = jF.scaled_dot_product_attention(
            Tensor(jnp.asarray(q)), Tensor(jnp.asarray(k)),
            Tensor(jnp.asarray(v)), is_causal=True, training=False)
    finally:
        set_flags(keep)
    got = tF.scaled_dot_product_attention(_t(q), _t(k), _t(v),
                                          is_causal=True, training=False)
    np.testing.assert_allclose(_np(got), np.asarray(want._data),
                               rtol=F32_TOL, atol=F32_TOL)


# ---------------------------------------------------------------------------
# K2: LayerNorm
# ---------------------------------------------------------------------------

# name: (dtype, H, mean offset of x).  "offset": x = 100 + N(0, 1), where a
# one-pass variance E[x²] - mean² would lose the digits; "odd": an H that
# is not a multiple of 4 (the CUDA kernel's generic route).
LN_CASES = {
    "float32": ("float32", 96, None),
    "bfloat16": ("bfloat16", 96, None),
    "offset-float32": ("float32", 96, 100.0),
    "odd-float32": ("float32", 97, None),
    "odd-bfloat16": ("bfloat16", 97, None),
}


def _one_pass_layer_norm(x, w, b, eps):
    xf = x.float()
    m = xf.mean(dim=-1, keepdim=True)
    var = xf.square().mean(dim=-1, keepdim=True) - m.square()
    return (xf - m) * torch.rsqrt(var + eps) * w + b


@pytest.mark.parametrize("case", list(LN_CASES))
def test_layer_norm_plain_matches_jax_kernel(case):
    """y, dx, dw, db on x [40, H] (40 rows: a ragged last row block of
    the JAX kernel's 16).  fp32: F32_TOL; bf16 x with fp32 w/b (the O2
    layout): BF16_TOL.

    At the mean offset the two fp32 means (JAX's and torch's sums in other
    orders) differ by an ulp or two of 100 (7.6e-6 each), and y and dw
    carry that difference d_i: y by -d_i rstd_i w, dw by -sum_i g_i
    rstd_i d_i, up to 2e-4 over 40 rows.  JAX's y and dw are moved by
    those first-order terms, from its own saved mean and rstd, before the
    comparison at F32_TOL; the one-pass formula, moved the same way,
    misses y by ~4e-3, so the case would catch it."""
    dtype, h, offset = LN_CASES[case]
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    rs = np.random.RandomState(7)
    if offset is None:
        x = rs.randn(40, h).astype(np.float32) * 2 + 0.5
    else:
        x = rs.randn(40, h).astype(np.float32) + offset
    w = 1 + 0.1 * rs.randn(h).astype(np.float32)
    b = 0.1 * rs.randn(h).astype(np.float32)
    g = rs.randn(40, h).astype(np.float32)

    def f(x, w, b):
        return jln.layer_norm_pallas(x, w, b, 1e-5, 16, True)
    jy, vjp = jax.vjp(f, _j(x, jdt), _j(w), _j(b))
    want = [_np(a) for a in (jy,) + tuple(vjp(_j(g, jdt)))]

    tx, tw, tb = _t(x, tdt, True), _t(w, grad=True), _t(b, grad=True)
    ty = tln.layer_norm(tx, tw, tb, 1e-5)
    got = (ty,) + torch.autograd.grad(ty, (tx, tw, tb), _t(g, tdt))
    assert ty.dtype == tdt
    if offset is not None:
        _, jm, jr = jln._fwd(_j(x), _j(w), _j(b), 1e-5, 16, True)
        jm, jr = (np.asarray(a, np.float64)[:, 0] for a in (jm, jr))
        d = _t(x).mean(dim=-1).double().numpy() - jm
        want[0] = want[0] - (d * jr)[:, None] * w
        want[2] = want[2] - (g * (jr * d)[:, None]).sum(0)
        one_pass = _one_pass_layer_norm(_t(x), _t(w), _t(b), 1e-5)
        assert np.max(np.abs(_np(one_pass) - want[0])) > 10 * tol
    for name, wv, gv in zip(("y", "dx", "dw", "db"), want, got):
        np.testing.assert_allclose(_np(gv), wv, rtol=tol, atol=tol,
                                   err_msg=name)


def test_layer_norm_routes():
    """The wrapper's route: the vector route at 768, 2048 and 4096 with
    every pointer 16-byte aligned; the generic one for any other width up
    to 8192 and for a view one element past alignment; the wide one for
    any wider row; no route for an empty row."""
    w = torch.ones(2048)
    for h in (768, 2048, 4096):
        x = torch.zeros(4, h)
        assert tln.route(h, (x, torch.ones(h))) == "vector"
    for h in (40, 96, 97, 1000, 1001, 5120, 8192):
        x = torch.zeros(4, h)
        assert tln.route(h, (x, torch.ones(h))) == "generic"
    flat = torch.zeros(4 * 2048 + 1)
    view = flat[1:].view(4, 2048)
    assert view.data_ptr() % 16 != 0
    assert tln.route(2048, (view, w)) == "generic"
    for h in (8193, 10007, 12288, 29056):
        assert tln.route(h, (torch.zeros(1, h),)) == "wide"
    with pytest.raises(ValueError, match="no LayerNorm route"):
        tln.route(0, (torch.zeros(1, 0),))


@pytest.mark.parametrize("dtype,h", [("float32", 12288), ("bfloat16", 12288),
                                     ("float32", 10007)])
def test_layer_norm_wide_rows_match_jax_kernel(dtype, h):
    """Rows wider than 8192 (the card's wide route): y, dx, dw, db of the
    plain version on x [4, H] against the JAX Pallas kernel (interpret
    mode), F32_TOL in fp32 and BF16_TOL in bf16, as at the narrow
    widths."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    rs = np.random.RandomState(8)
    x = rs.randn(4, h).astype(np.float32) * 2 + 0.5
    w = 1 + 0.1 * rs.randn(h).astype(np.float32)
    b = 0.1 * rs.randn(h).astype(np.float32)
    g = rs.randn(4, h).astype(np.float32)

    def f(x, w, b):
        return jln.layer_norm_pallas(x, w, b, 1e-5, 16, True)
    jy, vjp = jax.vjp(f, _j(x, jdt), _j(w), _j(b))
    want = [_np(a) for a in (jy,) + tuple(vjp(_j(g, jdt)))]
    tx, tw, tb = _t(x, tdt, True), _t(w, grad=True), _t(b, grad=True)
    ty = tln.layer_norm(tx, tw, tb, 1e-5)
    got = (ty,) + torch.autograd.grad(ty, (tx, tw, tb), _t(g, tdt))
    assert tln.route(h, (tx, tw, tb)) == "wide"
    for name, wv, gv in zip(("y", "dx", "dw", "db"), want, got):
        np.testing.assert_allclose(_np(gv), wv, rtol=tol, atol=tol,
                                   err_msg=name)


@pytest.mark.parametrize("entry", ["bhsd", "fwd", "bwd"])
def test_flash_attention_rejects_rows_that_see_no_key(entry):
    """``causal`` with ``q_offset < 0`` leaves the first query rows no
    key, where the reference's answer depends on its block size: every
    entry point raises, on CPU tensors as on CUDA ones; ``q_offset`` 0 and
    the non-causal case still compute."""
    q = torch.randn(2, 8, 16)
    k = torch.randn(2, 4, 16)
    calls = {
        "bhsd": lambda c, o: tfa.flash_attention_bhsd(q, k, k, 0.25, c,
                                                      q_offset=o),
        "fwd": lambda c, o: tfa.flash_attention_fwd(q, k, k, 0.25, c, o),
        "bwd": lambda c, o: tfa.flash_attention_bwd(q, k, k, q, q[..., 0],
                                                    q, 0.25, c, o),
    }
    with pytest.raises(ValueError, match="q_offset -1"):
        calls[entry](True, -1)
    with pytest.raises(ValueError, match="q_offset -4"):
        calls[entry](True, -4)
    if entry == "bhsd":
        assert calls[entry](True, 0).shape == q.shape
        assert calls[entry](False, -4).shape == q.shape


def test_layer_norm_is_not_the_serving_numerics():
    """K2 keeps fp32 through ``* w + b``; ``fused_decode``'s reference
    casts the normalised value to bf16 first.  On bf16 input they must
    differ somewhere, and K2's plain version must equal the fp32 formula
    rounded once."""
    from paddle_tpu_torch.ops.fused_decode import reference_layer_norm
    rs = np.random.RandomState(2)
    x = _t(rs.randn(16, 64) * 3, torch.bfloat16)
    w = _t(1 + 0.3 * rs.randn(64))
    b = _t(0.3 * rs.randn(64))
    k2 = tln.layer_norm(x, w, b, 1e-5)
    once = tln.layer_norm_ref(x.float(), w, b, 1e-5).to(torch.bfloat16)
    assert torch.equal(k2, once)
    serving = reference_layer_norm(x, w.to(torch.bfloat16),
                                   b.to(torch.bfloat16), 1e-5)
    assert not torch.equal(k2, serving)


# ---------------------------------------------------------------------------
# K3: fused AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("low", [False, True], ids=["fp32", "bf16-master"])
def test_adamw_plain_matches_jax_kernel(interpret, low):
    """Three steps with weight decay on, the bias-correction powers
    advanced per step as the JAX optimizer does.  ``low``: an fp32 master
    with a bf16 gradient and a bf16 copy written in the same pass.
    Tolerance rtol 1e-6, atol 1e-7 (see the module docstring)."""
    rs = np.random.RandomState(11)
    n = 300                                     # not a multiple of 128
    p0 = rs.randn(n).astype(np.float32)
    grads = [rs.randn(n).astype(np.float32) for _ in range(3)]
    b1, b2, eps, wd, lr = 0.9, 0.999, 1e-8, 0.01, 1e-3
    gdt_j = jnp.bfloat16 if low else jnp.float32
    gdt_t = torch.bfloat16 if low else torch.float32

    jp, jm, jv = _j(p0), jnp.zeros(n, jnp.float32), jnp.zeros(n, jnp.float32)
    jb1p = jb2p = jnp.ones((), jnp.float32)
    tp, tm, tv = _t(p0), torch.zeros(n), torch.zeros(n)
    tlow = tp.to(torch.bfloat16) if low else None
    tpows = torch.ones(2)
    tlr = torch.tensor([lr])
    betas = torch.tensor([b1, b2])
    for g in grads:
        jb1p, jb2p = jb1p * b1, jb2p * b2
        jp = jp * (1.0 - jnp.float32(lr) * wd)   # AdamW decays before
        jp, jm, jv = jadamw.fused_adamw_update(
            jp, _j(g, gdt_j), jm, jv, jnp.float32(lr), jb1p, jb2p, b1, b2,
            eps, wd=0.0)
        tpows.mul_(betas)
        tadamw.fused_adamw_update_(tp, _t(g, gdt_t), tm, tv, tlr,
                                   tpows[0:1], tpows[1:2], b1, b2, eps, wd,
                                   p_low=tlow)
    for name, w, g in (("p", jp, tp), ("m", jm, tm), ("v", jv, tv)):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-6, atol=1e-7,
                                   err_msg=name)
    if low:
        assert torch.equal(tlow, tp.to(torch.bfloat16))


def test_cpu_wrappers_launch_no_kernel():
    """On CPU tensors every wrapper takes its plain version: no launch
    counter moves."""
    before = (dict(tfa.launches), dict(tln.launches), tadamw.launches)
    arrs, kw = _flash_inputs("causal")
    _port_flash(arrs, kw, torch.float32)
    x = torch.randn(4, 8, requires_grad=True)
    tln.layer_norm(x, torch.ones(8), torch.zeros(8)).sum().backward()
    p = torch.randn(8)
    tadamw.fused_adamw_update_(p, torch.randn(8), torch.zeros(8),
                               torch.zeros(8), torch.tensor([1e-3]),
                               torch.tensor([0.9]), torch.tensor([0.999]),
                               0.9, 0.999, 1e-8)
    assert (dict(tfa.launches), dict(tln.launches), tadamw.launches) \
        == before


def test_cuda_only_entry_points_refuse_cpu_tensors():
    """The kernel-only entry points (used by ``chip_smoke.py`` and the
    autograd functions) raise on CPU tensors instead of computing."""
    q = torch.randn(2, 8, 16)
    with pytest.raises(ValueError, match="device"):
        tfa.flash_attention_fwd(q, q, q, 0.25, True)
    with pytest.raises(ValueError, match="device"):
        tln.layer_norm_fwd(torch.randn(4, 8), torch.ones(8), torch.zeros(8),
                           1e-5)
