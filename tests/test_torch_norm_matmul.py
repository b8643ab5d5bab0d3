"""K6d (``ops.fused_decode.norm_matmul``, the kernel the program passes'
claim routes to) held against the JAX package on the CPU: the port's
wrapper, which takes its plain version on CPU tensors, against JAX
``fused_decode.norm_matmul`` run as ``tests/test_decode_loop.py`` runs
it (the Pallas kernel in interpret mode, ``FLAGS_pallas_interpret``) and
through its reference branch, on the same numpy inputs.  Covered:
LayerNorm and RMSNorm, with and without the matmul bias, 2-D and 3-D x,
a transposed-view weight (a ``transpose_y`` head), an odd H and N (the
JAX gate's multiple-of-8 rule sends those to its reference), bf16; then
the card's gate.

Tolerances:
* fp32: 2e-5 (the same products summed in other orders: the Pallas
  kernel's fp32 dot vs torch's matmul; the norm's sums);
* bf16: 3e-2, compared in fp32 on outputs below 2: the Pallas kernel
  computes in fp32 and rounds once, the references (and the port's plain
  version, which mirrors them) round the normalized rows and the product
  to bf16 on the way — a few bf16 steps (2^-7 at 1-2).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.flags import get_flags, set_flags
from paddle_tpu.ops.pallas import fused_decode as jfd
from paddle_tpu_torch.ops import fused_decode as tfd

F32_TOL = 2e-5
BF16_TOL = 3e-2


def _tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_TOL


def _t(a, dtype="float32"):
    return torch.tensor(np.asarray(a, np.float32)).to(getattr(torch, dtype))


def _j(a, dtype="float32"):
    return jnp.asarray(np.asarray(a, np.float32)).astype(getattr(jnp, dtype))


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


def _case(seed, lead, h, n, kind, bias):
    rs = np.random.RandomState(seed)
    x = rs.randn(*lead, h) * 2.0
    nw = rs.rand(h) + 0.5
    nb = rs.randn(h) * 0.1 if kind == "layer_norm" else None
    w = rs.randn(h, n) / np.sqrt(h)
    b = rs.randn(n) * 0.1 if bias else None
    return x, nw, nb, w, b


def _both(x, nw, nb, w, b, kind, eps, dtype, transposed=False):
    """(port's wrapper, JAX norm_matmul, JAX reference branch) on the same
    inputs; ``transposed``: w arrives as the transpose of a row-major
    [N, H] tensor, a view in the port."""
    conv = (lambda f, a: None if a is None else f(a, dtype))
    if transposed:
        tw = _t(np.ascontiguousarray(w.T), dtype).transpose(0, 1)
        assert tw.stride(0) == 1
    else:
        tw = _t(w, dtype)
    got = tfd.norm_matmul(conv(_t, x), conv(_t, nw), conv(_t, nb), tw,
                          conv(_t, b), kind=kind, eps=eps)
    jargs = [conv(_j, a) for a in (x, nw, nb, w, b)]
    want = jfd.norm_matmul(*jargs, kind=kind, eps=eps)
    set_flags({"FLAGS_pallas_interpret": False})
    try:
        ref = jfd.norm_matmul(*jargs, kind=kind, eps=eps)
    finally:
        set_flags({"FLAGS_pallas_interpret": True})
    return got, want, ref


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["layer_norm", "rms_norm"])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("lead", [(3,), (2, 1)], ids=["2d", "3d"])
@pytest.mark.parametrize("transposed", [False, True],
                         ids=["row_major", "transposed_view"])
def test_norm_matmul_matches_jax(interpret, dtype, kind, bias, lead,
                                 transposed):
    h, n = 32, 16
    args = _case(7, lead, h, n, kind, bias)
    eps = 1e-5 if kind == "layer_norm" else 1e-6
    assert jfd.norm_matmul_supported(h, n, h * n * 4)   # Pallas, interpret
    got, want, ref = _both(*args, kind, eps, dtype, transposed)
    assert tuple(got.shape) == (*lead, n)
    assert got.dtype == getattr(torch, dtype)
    tol = _tol(dtype)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg="vs the Pallas kernel")
    np.testing.assert_allclose(_np(got), _np(ref), rtol=tol, atol=tol,
                               err_msg="vs the JAX reference")


@pytest.mark.parametrize("kind", ["layer_norm", "rms_norm"])
def test_odd_h_and_n_take_the_jax_reference_route(interpret, kind):
    """H = 40 passes the JAX gate's multiple-of-8 rule, N = 37 does not,
    so the JAX side runs its reference; the port's plain version is the
    same composition."""
    args = _case(3, (5,), 40, 37, kind, True)
    assert not jfd.norm_matmul_supported(40, 37, 40 * 37 * 4)
    got, want, ref = _both(*args, kind, 1e-5, "float32", True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=F32_TOL,
                               atol=F32_TOL)


def test_rms_norm_ignores_a_norm_bias():
    """RMSNorm reads no norm bias, on either side (the JAX kernel and
    reference never add it)."""
    x, nw, _, w, b = _case(5, (4,), 32, 8, "rms_norm", True)
    nb = np.ones(32)
    a = tfd.norm_matmul(_t(x), _t(nw), _t(nb), _t(w), _t(b),
                        kind="rms_norm", eps=1e-6)
    c = tfd.norm_matmul(_t(x), _t(nw), None, _t(w), _t(b),
                        kind="rms_norm", eps=1e-6)
    assert torch.equal(a, c)


def test_gate_rows_layouts_and_devices():
    w = torch.zeros(32, 16)
    assert tfd.norm_matmul_admits(torch.zeros(64, 32), w)
    assert tfd.norm_matmul_admits(torch.zeros(8, 8, 32), w)   # 64 rows
    # more than 64 rows take the composition (routing by shape)
    assert not tfd.norm_matmul_admits(torch.zeros(65, 32), w)
    assert not tfd.norm_matmul_admits(torch.zeros(5, 13, 32), w)
    # both weight layouts; not a weight with neither rows nor columns
    # contiguous
    assert tfd.norm_matmul_admits(torch.zeros(8, 32),
                                  torch.zeros(16, 32).t())
    assert not tfd.norm_matmul_admits(torch.zeros(8, 32),
                                      torch.zeros(32, 32)[:, ::2])
    # one dtype across x, w and the bias; fp32 or bf16
    assert not tfd.norm_matmul_admits(torch.zeros(8, 32),
                                      w.to(torch.bfloat16))
    assert not tfd.norm_matmul_admits(torch.zeros(8, 32), w,
                                      torch.zeros(16, dtype=torch.bfloat16))
    assert tfd.norm_matmul_admits(torch.zeros(8, 32, dtype=torch.bfloat16),
                                  w.to(torch.bfloat16),
                                  torch.zeros(16, dtype=torch.bfloat16))
    assert not tfd.norm_matmul_admits(torch.zeros(8, 32,
                                                  dtype=torch.float16),
                                      w.half())


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    before = dict(tfd.launches)
    x, nw, nb, w, b = _case(9, (70,), 32, 16, "layer_norm", True)
    args = (_t(x), _t(nw), _t(nb), _t(w), _t(b))
    got = tfd.norm_matmul(*args, kind="layer_norm", eps=1e-5)
    want = tfd.norm_matmul_ref(*args, kind="layer_norm", eps=1e-5)
    assert torch.equal(got, want)
    assert tfd.launches == before
    with pytest.raises(ValueError, match="unknown norm kind"):
        tfd.norm_matmul(*args, kind="batch_norm")
    # a tensor on neither the CPU nor CUDA raises, admitted or not
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        tfd.norm_matmul(meta[0][:8], *meta[1:], kind="layer_norm")
    with pytest.raises(ValueError, match="unsupported device"):
        tfd.norm_matmul(*meta, kind="layer_norm")


# ---------------------------------------------------------------------------
# the stream route on the card: its rule and its plan (pure functions)
# ---------------------------------------------------------------------------

# K6d's main-path products (phase 15 of chip_smoke.py, the program-pass
# paths): name: (x's rows, H, N, transposed, dtype)
MAIN_PATH = {
    "gpt_qkv": (8, 2048, 6144, False, torch.float32),
    "gpt_fc1": (8, 2048, 8192, False, torch.float32),
    "gpt_head": (8, 2048, 50304, True, torch.float32),
    "llama_head": (8, 4096, 32000, True, torch.float32),
    "bf16_head": (8, 4096, 32000, True, torch.bfloat16),
    "bf16_fc1": (8, 2048, 8192, False, torch.bfloat16),
    "rows1": (1, 2048, 50304, True, torch.float32),
    "rows33": (33, 2048, 6144, False, torch.float32),
    "rows64": (64, 4096, 32000, True, torch.float32),
}


def _meta_weight(h, n, transposed, dtype):
    if transposed:
        return torch.empty(n, h, dtype=dtype, device="meta").t()
    return torch.empty(h, n, dtype=dtype, device="meta")


@pytest.mark.parametrize("name", list(MAIN_PATH))
def test_main_path_shapes_take_the_stream_route(name):
    rows, h, n, transposed, dtype = MAIN_PATH[name]
    x = torch.empty(rows, h, dtype=dtype, device="meta")
    w = _meta_weight(h, n, transposed, dtype)
    assert tfd.norm_matmul_admits(x, w)
    assert tfd.norm_matmul_route(x, w) == "stream"
    assert tfd.fd_route(transposed, rows, n, h, h if transposed else n,
                        dtype, True) == 1


def test_odd_shapes_and_unaligned_views_take_the_generic_route():
    """Phase 15's ``odd`` / ``odd_t`` (H 40, N 37), a bf16 N that is a
    multiple of 4 but not of 8, an unaligned x or weight view, a row
    stride that is not a multiple of the vector: the generic GEMV."""
    assert tfd.norm_matmul_route(torch.zeros(5, 40),
                                 torch.zeros(40, 37)) == "generic"
    assert tfd.norm_matmul_route(torch.zeros(3, 2, 40),
                                 torch.zeros(37, 40).t()) == "generic"
    assert tfd.norm_matmul_route(
        torch.zeros(8, 64, dtype=torch.bfloat16),
        torch.zeros(64, 36, dtype=torch.bfloat16)) == "generic"
    x = torch.zeros(8 * 64 + 1)[1:].view(8, 64)
    assert x.data_ptr() % 16 and \
        tfd.norm_matmul_route(x, torch.zeros(64, 32)) == "generic"
    w = torch.zeros(64 * 32 + 1)[1:].view(64, 32)
    assert tfd.norm_matmul_route(torch.zeros(8, 64), w) == "generic"
    w = torch.zeros(64, 34)[:, :32]                 # row stride 34
    assert tfd.norm_matmul_route(torch.zeros(8, 64), w) == "generic"
    assert tfd.norm_matmul_route(torch.zeros(8, 64),
                                 torch.zeros(64, 32)) == "stream"
    # the rule itself: rows past the gate, an unaligned call
    assert tfd.fd_route(False, 65, 32, 64, 32, torch.float32, True) == 0
    assert tfd.fd_route(False, 8, 32, 64, 32, torch.float32, False) == 0
    assert tfd.fd_route(True, 8, 32, 64, 60, torch.float32, True) == 0


def _plan_units(name, blocks):
    rows, h, n, transposed, dtype = MAIN_PATH[name]
    tn, ks = tfd.stream_geometry(transposed, dtype.itemsize)
    return tfd.stream_plan(-(-n // tn), -(-h // ks), blocks)


@pytest.mark.parametrize("blocks", [132, 264, 1, 7, 131, 1000, 10 ** 6])
@pytest.mark.parametrize("name", list(MAIN_PATH))
def test_stream_plan_covers_every_unit_once(name, blocks):
    """Every (tile, K step) unit lies in exactly one block's share, the
    shares are contiguous and tile-major, differ by at most one unit, and
    each block cuts at most two tiles (its parts' slots 0 and 1)."""
    plan = _plan_units(name, blocks)
    shares = tfd.stream_shares(plan)
    units = plan.tiles * plan.ksteps
    assert plan.grid == min(blocks, units)
    assert shares[0][0] == 0 and shares[-1][1] == units
    assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
    lengths = {end - start for start, end in shares}
    assert max(lengths) - min(lengths) <= 1 and min(lengths) >= 1
    seen = {}
    for t in range(plan.tiles):
        parts = tfd.stream_contributors(plan, t)
        covered = sum(min(e, (t + 1) * plan.ksteps) - max(s, t *
                                                            plan.ksteps)
                      for s, e in (shares[j] for j, _ in parts))
        assert covered == plan.ksteps
        assert [j for j, _ in parts] == sorted(j for j, _ in parts)
        for j, slot in parts:
            if len(parts) > 1:
                seen.setdefault((j, slot), []).append(t)
    assert all(len(ts) == 1 for ts in seen.values())


def _stream_model(xn, w, plan, tn, ks):
    """The kernel's arithmetic in torch: each block sums its units' fp32
    products tile by tile; a whole tile is written at once, a cut one
    from the blocks' parts added in block order."""
    b, n = xn.shape[0], w.shape[1]
    out = torch.full((b, plan.tiles * tn), float("nan"))
    parts = {}
    for j, (start, end) in enumerate(tfd.stream_shares(plan)):
        first = start // plan.ksteps
        for t in range(first, (end - 1) // plan.ksteps + 1):
            lo = max(start, t * plan.ksteps) - t * plan.ksteps
            hi = min(end, (t + 1) * plan.ksteps) - t * plan.ksteps
            acc = torch.zeros(b, tn)
            for s in range(lo, hi):
                wt = torch.zeros(ks, tn)
                blk = w[s * ks:(s + 1) * ks, t * tn:(t + 1) * tn]
                wt[:blk.shape[0], :blk.shape[1]] = blk
                xk = torch.zeros(b, ks)
                xb = xn[:, s * ks:(s + 1) * ks]
                xk[:, :xb.shape[1]] = xb
                acc = acc + xk @ wt
            if hi - lo == plan.ksteps:
                out[:, t * tn:(t + 1) * tn] = acc
            else:
                parts[(j, 0 if t == first else 1)] = acc
    for t in range(plan.tiles):
        cut = tfd.stream_contributors(plan, t)
        if any(key in parts for key in cut):
            s = torch.zeros(b, tn)
            for key in cut:
                s = s + parts[key]
            out[:, t * tn:(t + 1) * tn] = s
    return out[:, :n]


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("blocks", [1, 5, 13, 64])
def test_stream_combine_model_matches_matmul(transposed, blocks):
    """A torch model of the plan's fixed-order combine (parts summed in
    block order) equals ``xn @ w`` within fp32 2e-5, on a shape with a
    ragged last tile and step, and gives the same bits twice."""
    rs = np.random.RandomState(blocks)
    h, n = (600, 100) if transposed else (100, 600)
    xn = torch.from_numpy(rs.randn(8, h).astype(np.float32))
    w = torch.from_numpy(rs.randn(h, n).astype(np.float32) * 0.05)
    tn, ks = tfd.stream_geometry(transposed, 4)
    plan = tfd.stream_plan(-(-n // tn), -(-h // ks), blocks)
    got = _stream_model(xn, w, plan, tn, ks)
    np.testing.assert_allclose(got.numpy(), (xn @ w).numpy(), rtol=F32_TOL,
                               atol=F32_TOL)
    assert torch.equal(got, _stream_model(xn, w, plan, tn, ks))
