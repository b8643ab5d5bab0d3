"""The LLaMA kernels of the PyTorch port (RMSNorm K4a/K4b, rotary
embedding K5) held against the JAX package on the CPU: each module's
plain version and its wrapper (which takes the plain version on a CPU
tensor) against the JAX Pallas kernels run as the JAX tests run them
(``interpret=True``), on the same numpy inputs.  Gradients: torch
autograd through the port against ``jax.vjp`` through the JAX
``custom_vjp`` (the hand-written RMSNorm dx kernel; for rope, the same
kernel with sin negated).

Tolerances:
* fp32: 2e-5 (the same math summed in other orders: the Pallas kernels'
  row blocks vs torch's reductions; dw sums 40 rows);
* bf16: 2e-2, compared in fp32: one bf16 rounding step of values below
  4 (both sides round once from fp32 results that may differ by a few
  ulps).

The incubate routes are held against the JAX incubate functions with
the Pallas routes in interpret mode, and their gate is checked: plain
``[S, D]`` pair-repeating tables and no ``position_ids`` take the kernel
route; a 3-D table, ``position_ids`` or a table that does not repeat
across its pairs take the composition, as in the JAX route.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu.flags import get_flags, set_flags
from paddle_tpu.incubate.nn import functional as jIF
from paddle_tpu.ops.pallas import rms_norm as jrms
from paddle_tpu.ops.pallas import rope as jrope
from paddle_tpu_torch import amp
from paddle_tpu_torch.incubate.nn import functional as tIF
from paddle_tpu_torch.ops import rms_norm as trms
from paddle_tpu_torch.ops import rope as trope

F32_TOL = 2e-5
BF16_TOL = 2e-2
DTYPES = ["float32", "bfloat16"]


def _t(a, dtype=torch.float32, grad=False):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype) \
        .requires_grad_(grad)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    if isinstance(x, paddle.Tensor):
        x = x._data
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_TOL


@pytest.fixture
def interpret():
    keep = get_flags(["FLAGS_pallas_interpret"])
    set_flags({"FLAGS_pallas_interpret": True})
    yield
    set_flags(keep)


# ---------------------------------------------------------------------------
# K4: RMSNorm
# ---------------------------------------------------------------------------

def _rms_inputs(seed=7, n=40, h=96):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, h).astype(np.float32) * 2 + 0.5
    w = 1 + 0.1 * rs.randn(h).astype(np.float32)
    g = rs.randn(n, h).astype(np.float32)
    return x, w, g


@pytest.mark.parametrize("fn", ["rms_norm_ref", "rms_norm"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm_matches_jax_kernel(dtype, fn):
    """y, dx, dw on x [40, 96] (40 rows: a ragged last row block of the
    JAX kernel's 16), fp32 w (the O2 layout of a kept-fp32 norm)."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    x, w, g = _rms_inputs()

    def f(x, w):
        return jrms.rms_norm_pallas(x, w, 1e-5, 16, True)
    jy, vjp = jax.vjp(f, _j(x, jdt), _j(w))
    want = (jy,) + tuple(vjp(_j(g, jdt)))

    tx, tw = _t(x, tdt, True), _t(w, grad=True)
    ty = getattr(trms, fn)(tx, tw, 1e-5)
    got = (ty,) + torch.autograd.grad(ty, (tx, tw), _t(g, tdt))
    assert ty.dtype == tdt and got[1].dtype == tdt
    for name, wv, gv in zip(("y", "dx", "dw"), want, got):
        np.testing.assert_allclose(_np(gv), _np(wv), rtol=_tol(dtype),
                                   atol=_tol(dtype), err_msg=name)


def test_rms_norm_plain_is_fp32_rounded_once():
    """On bf16 input the plain version equals the fp32 formula on the
    upcast input rounded once to bf16, over a 3-D x."""
    rs = np.random.RandomState(3)
    x = _t(rs.randn(2, 5, 64) * 3, torch.bfloat16)
    w = _t(1 + 0.3 * rs.randn(64))
    xf = x.float()
    once = (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + 1e-6)
            * w).to(torch.bfloat16)
    assert torch.equal(trms.rms_norm(x, w), once)


@pytest.mark.parametrize("o2", [False, True], ids=["fp32", "o2"])
def test_fused_rms_norm_matches_jax_incubate(interpret, o2):
    """``fused_rms_norm`` with a bias, against the JAX incubate function
    (Pallas route, interpret mode).  Under O2 a bf16 x goes up to fp32
    and the output stays fp32 on both sides ("rms_norm" is
    black-listed).  F32_TOL."""
    x, w, _ = _rms_inputs(8, 6, 64)
    bias = np.linspace(-1, 1, 64).astype(np.float32)
    jx, tx = _j(x), _t(x)
    if o2:
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    jctx = jamp.auto_cast(enable=o2, level="O2", dtype="bfloat16")
    tctx = amp.auto_cast(enable=o2, level="O2", dtype="bfloat16")
    with jctx:
        want, _ = jIF.fused_rms_norm(paddle.Tensor(jx), paddle.Tensor(_j(w)),
                                     paddle.Tensor(_j(bias)), epsilon=1e-5)
    with tctx:
        got, none = tIF.fused_rms_norm(tx, _t(w), _t(bias), epsilon=1e-5)
    assert none is None
    assert got.dtype == torch.float32
    assert str(want._data.dtype) == "float32"
    np.testing.assert_allclose(_np(got), _np(want), rtol=F32_TOL,
                               atol=F32_TOL)


# ---------------------------------------------------------------------------
# K5: rotary embedding
# ---------------------------------------------------------------------------

def _tables(s, d, neox, theta=10000.0):
    inv = 1.0 / (theta ** (np.arange(0, d, 2) / d))
    freqs = np.outer(np.arange(s), inv).astype(np.float32)
    table = np.concatenate([freqs, freqs], -1) if neox \
        else np.repeat(freqs, 2, -1)
    return np.cos(table), np.sin(table)


def _rope_inputs(neox, seed=5, b=2, s=24, h=3, d=16):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, s, h, d).astype(np.float32)
    g = rs.randn(b, s, h, d).astype(np.float32)
    cos, sin = _tables(s, d, neox)
    return x, g, cos, sin


def _bhsd(a):
    b, s, h, d = a.shape
    return a.transpose(0, 2, 1, 3).reshape(b * h, s, d)


@pytest.mark.parametrize("fn", ["rope_ref", "rope"])
@pytest.mark.parametrize("neox", [False, True], ids=["interleaved", "neox"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rope_matches_jax_kernel(dtype, neox, fn):
    """out and dx on x [2, 24, 3, 16] ([B, S, H, D]; the JAX kernel takes
    the [B*H, S, D] transpose, with S=24 a ragged last block of its 16).
    bf16: the tables are rounded to bf16 first, as the O2 dispatch rounds
    them; the JAX route promotes them to fp32, the port's kernel reads
    them as bf16 and computes in fp32."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    x, g, cos, sin = _rope_inputs(neox)
    tcos, tsin = _t(cos, tdt), _t(sin, tdt)
    jcos, jsin = _j(_np(tcos)), _j(_np(tsin))

    def f(x):
        return jrope.rope_bhsd(x, jcos, jsin, neox, 16, True)
    jy, vjp = jax.vjp(f, _j(_bhsd(x), jdt))
    (jdx,) = vjp(_j(_bhsd(g), jdt))

    tx = _t(x, tdt, True)
    ty = getattr(trope, fn)(tx, tcos, tsin, neox)
    (tdx,) = torch.autograd.grad(ty, tx, _t(g, tdt))
    assert ty.dtype == tdt and tdx.dtype == tdt
    for name, wv, gv in (("out", jy, ty), ("dx", jdx, tdx)):
        np.testing.assert_allclose(_bhsd(_np(gv)), _np(wv),
                                   rtol=_tol(dtype), atol=_tol(dtype),
                                   err_msg=name)


@pytest.fixture
def kernel_route(monkeypatch):
    """Counts the calls of the rope kernel route (``ops.rope.rope``) from
    the incubate function."""
    calls = []
    real = trope.rope

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)
    monkeypatch.setattr(trope, "rope", counting)
    return calls


def _jax_incubate_rope(x, cos, sin, neox, position_ids=None):
    keep = get_flags(["FLAGS_pallas_interpret"])
    set_flags({"FLAGS_pallas_interpret": True})
    try:
        q, k, v = jIF.fused_rotary_position_embedding(
            paddle.Tensor(_j(x)), None, None, sin=paddle.Tensor(_j(sin)),
            cos=paddle.Tensor(_j(cos)),
            position_ids=None if position_ids is None
            else paddle.Tensor(jnp.asarray(position_ids)),
            use_neox_rotary_style=neox)
    finally:
        set_flags(keep)
    assert k is None and v is None
    return q


@pytest.mark.parametrize("neox", [False, True], ids=["interleaved", "neox"])
def test_incubate_rope_takes_the_kernel_route(kernel_route, neox):
    """Plain [S, D] pair-repeating tables, no position_ids: the kernel
    route, for q and for k; fp32 values against the JAX incubate function
    (its Pallas route), F32_TOL."""
    x, _, cos, sin = _rope_inputs(neox)
    q, k, v = tIF.fused_rotary_position_embedding(
        _t(x), _t(x[..., ::-1].copy()), None, sin=_t(sin), cos=_t(cos),
        use_neox_rotary_style=neox)
    assert len(kernel_route) == 2 and v is None
    want = _jax_incubate_rope(x, cos, sin, neox)
    np.testing.assert_allclose(_np(q), _np(want), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("case", ["table_3d", "position_ids",
                                  "not_pair_repeating"])
def test_incubate_rope_gate_takes_the_composition(kernel_route, case):
    """A [B, S, D] table, position_ids, or a table whose pairs differ:
    the composition, as the JAX gate routes them; fp32 values against the
    JAX incubate function, F32_TOL.  (position_ids are the positions
    0..S-1 here: neither composition reads them.)"""
    neox = False
    x, _, cos, sin = _rope_inputs(neox)
    pos = None
    if case == "table_3d":
        cos, sin = np.stack([cos, cos[::-1]]), np.stack([sin, sin[::-1]])
    elif case == "position_ids":
        pos = np.tile(np.arange(x.shape[1]), (x.shape[0], 1))
    else:
        rs = np.random.RandomState(9)
        cos, sin = (rs.randn(*cos.shape).astype(np.float32)
                    for _ in range(2))
    q, _, _ = tIF.fused_rotary_position_embedding(
        _t(x), sin=_t(sin), cos=_t(cos),
        position_ids=None if pos is None else torch.from_numpy(pos),
        use_neox_rotary_style=neox)
    assert kernel_route == []
    want = _jax_incubate_rope(x, cos, sin, neox, pos)
    np.testing.assert_allclose(_np(q), _np(want), rtol=F32_TOL,
                               atol=F32_TOL)


def test_incubate_rope_position_ids_other_than_the_positions_raise():
    """The composition, like the JAX one, rotates by the tables' first
    rows whatever ``position_ids`` say (ROADMAP Queue 3), so
    ``position_ids`` other than ``0..S-1`` raise NotImplementedError
    rather than give the JAX result for positions that were not asked
    for."""
    x = _rope_inputs(False)[0]
    cos, sin = _tables(40, x.shape[-1], False)      # more rows than S
    pos = np.stack([np.arange(x.shape[1])[::-1],
                    np.arange(x.shape[1]) + 16])
    with pytest.raises(NotImplementedError, match="position_ids"):
        tIF.fused_rotary_position_embedding(
            _t(x), sin=_t(sin), cos=_t(cos),
            position_ids=torch.from_numpy(pos), use_neox_rotary_style=False)


def test_incubate_rope_o2_rounds_the_tables_to_bf16():
    """Under O2 "fused_rope" casts x and the fp32 tables to bf16 before
    the kernel computes in fp32, as the JAX dispatch does: the result is
    the plain version on bf16 tables, and differs from the one on fp32
    tables; within one bf16 step (BF16_TOL) of the JAX incubate function
    in interpret mode, eager (its kernel route)."""
    x, _, cos, sin = _rope_inputs(False, seed=6, s=64)
    tx = _t(x, torch.bfloat16)
    with amp.auto_cast(enable=True, level="O2", dtype="bfloat16"):
        q, _, _ = tIF.fused_rotary_position_embedding(
            tx, sin=_t(sin), cos=_t(cos), use_neox_rotary_style=False)
    bf = torch.bfloat16
    assert torch.equal(q, trope.rope_ref(tx, _t(cos, bf), _t(sin, bf),
                                         False))
    assert not torch.equal(q, trope.rope_ref(tx, _t(cos), _t(sin), False))
    keep = get_flags(["FLAGS_pallas_interpret"])
    set_flags({"FLAGS_pallas_interpret": True})
    try:
        with jamp.auto_cast(enable=True, level="O2", dtype="bfloat16"):
            want, _, _ = jIF.fused_rotary_position_embedding(
                paddle.Tensor(_j(x, jnp.bfloat16)),
                sin=paddle.Tensor(_j(sin)), cos=paddle.Tensor(_j(cos)),
                use_neox_rotary_style=False)
    finally:
        set_flags(keep)
    np.testing.assert_allclose(_np(q), _np(want), rtol=BF16_TOL,
                               atol=BF16_TOL)


def test_pair_check_is_memoised_per_table():
    """The table check reads a table once: a second slice of the same
    table is answered from the memo; an in-place change of the table is
    checked anew."""
    cos, sin = (torch.from_numpy(t) for t in _tables(32, 16, False))
    assert tIF._pair_repeating(sin[:8], False)
    key = next(k for k in tIF._pair_repeat_memo if k[0] == id(sin))
    assert tIF._pair_repeat_memo[key][1] is True
    assert tIF._pair_repeating(sin[:8], False)
    sin[0, 0] += 1.0
    assert not tIF._pair_repeating(sin[:8], False)
    assert tIF._pair_repeating(cos[:8], False)


def test_pair_check_reads_each_table_once_over_row_slices():
    """The eager decode loop slices one position of each table per token:
    the whole table is checked once and every row slice inherits the
    verdict, so the device is read once, not once per token and layer."""
    cos, sin = (torch.from_numpy(t) for t in _tables(32, 16, False))
    before = tIF.table_checks
    for pos in range(16):
        assert tIF._pair_repeating(sin[pos:pos + 1], False)
    assert tIF.table_checks - before == 1
    # a view that is not whole rows is checked on its own
    assert tIF._pair_repeating(sin[:4, :8], False)
    assert tIF.table_checks - before == 2


# ---------------------------------------------------------------------------
# the wrappers' routes
# ---------------------------------------------------------------------------

def test_cpu_wrappers_launch_no_kernel():
    """On CPU tensors both wrappers take their plain versions: no launch
    counter moves."""
    before = (dict(trms.launches), trope.launches)
    x = torch.randn(4, 8, requires_grad=True)
    trms.rms_norm(x, torch.ones(8)).sum().backward()
    cos, sin = (torch.from_numpy(t) for t in _tables(6, 8, False))
    xr = torch.randn(1, 6, 2, 8, requires_grad=True)
    trope.rope(xr, cos, sin, False).sum().backward()
    assert (dict(trms.launches), trope.launches) == before


def test_cuda_only_entry_points_refuse_cpu_tensors():
    """The kernel-only entry points (used by ``chip_smoke.py`` and the
    autograd functions) raise on CPU tensors instead of computing."""
    with pytest.raises(ValueError, match="device"):
        trms.rms_norm_fwd(torch.randn(4, 8), torch.ones(8), 1e-6)
    with pytest.raises(ValueError, match="device"):
        trms.rms_norm_bwd(torch.randn(4, 8), torch.ones(8),
                          torch.ones(4, 1), torch.randn(4, 8))
    cos, sin = (torch.from_numpy(t) for t in _tables(6, 8, False))
    with pytest.raises(ValueError, match="device"):
        trope.rope_fwd(torch.randn(1, 6, 2, 8), cos, sin, False)
