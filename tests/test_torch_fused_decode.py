"""The decode-step kernels of the PyTorch port (K6a rope + QKV, K6b attend
+ cache append, K6c norm + MLP) held against the JAX package on the CPU:
the port's wrappers, which take their plain versions on CPU tensors,
against the JAX Pallas kernels run as ``tests/test_decode_loop.py`` runs
them (``FLAGS_pallas_interpret``) and against the JAX references, on the
same numpy inputs.

Tolerances:
* fp32: 2e-5 (the same products summed in other orders: the Pallas
  kernels' fp32 dots vs torch's matmuls; softmax sums);
* bf16: 2e-2, compared in fp32: one bf16 step of values below 4.  The
  Pallas kernels compute in fp32 and round once; the references (and the
  port's plain versions, which mirror them) round the matmul outputs,
  the bias add and the attention probabilities to bf16 on the way.

The card's gate (``*_admits``) is checked for its routing rules.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.flags import get_flags, set_flags
from paddle_tpu.ops.pallas import fused_decode as jfd
from paddle_tpu_torch.ops import fused_decode as tfd

F32_TOL = 2e-5
BF16_TOL = 2e-2
DTYPES = ["float32", "bfloat16"]
HEADS = {"mha": (4, 4), "gqa": (4, 2)}
B, H, HD = 3, 32, 8


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


def _close(got, want, dtype, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=_tol(dtype),
                               atol=_tol(dtype), err_msg=what)


@pytest.fixture
def interpret():
    keep = get_flags(["FLAGS_pallas_interpret"])
    set_flags({"FLAGS_pallas_interpret": True})
    yield
    set_flags(keep)


def _rope_row(seed, neox):
    """One position's cos/sin row in the model's layout (each frequency
    repeated across its rotated pair)."""
    rs = np.random.RandomState(seed)
    ang = rs.rand(HD // 2).astype(np.float32) * 3
    full = np.concatenate([ang, ang]) if neox else np.repeat(ang, 2)
    return np.cos(full), np.sin(full)


# ---------------------------------------------------------------------------
# K6a: rope + QKV
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("heads", list(HEADS))
@pytest.mark.parametrize("rope,bias", [("none", True),
                                       ("interleaved", False),
                                       ("neox", True)])
def test_rope_qkv_matches_jax_kernel(interpret, dtype, heads, rope, bias):
    nh, nkv = HEADS[heads]
    rs = np.random.RandomState(11)
    x = rs.randn(B, H)
    ws = [rs.randn(H, n * HD) / np.sqrt(H) for n in (nh, nkv, nkv)]
    bs = [rs.randn(n * HD) * 0.1 for n in (nh, nkv, nkv)] if bias \
        else [None] * 3
    neox = rope == "neox"
    cs = _rope_row(3, neox) if rope != "none" else (None, None)
    kw = dict(n_heads=nh, n_kv=nkv, head_dim=HD, neox=neox)

    def conv(f, a):
        return None if a is None else f(a, dtype)

    def conv32(f, a):
        return None if a is None else f(a)

    got = tfd.rope_qkv(conv(_t, x), *(conv(_t, w) for w in ws),
                       *(conv(_t, b) for b in bs),
                       *(conv32(_t, c) for c in cs), **kw)
    jargs = ([conv(_j, x)] + [conv(_j, w) for w in ws]
             + [conv(_j, b) for b in bs] + [conv32(_j, c) for c in cs])
    want = jfd.rope_qkv(*jargs, **kw)
    assert jfd.available()
    ref = jfd._rope_qkv_reference(*jargs, nh, nkv, HD, neox)
    for g, w, r, name in zip(got, want, ref, "qkv"):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w, dtype, f"{name} vs the Pallas kernel")
        _close(g, r, dtype, f"{name} vs the JAX reference")


# ---------------------------------------------------------------------------
# K6b: attend + cache append
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("heads", list(HEADS))
@pytest.mark.parametrize("pos", [5, 11])
def test_attend_cache_append_matches_jax_kernel(interpret, dtype, heads,
                                                pos):
    nh, nkv = HEADS[heads]
    st = 12
    rs = np.random.RandomState(pos)
    q, kn, vn = (rs.randn(B, n, HD) for n in (nh, nkv, nkv))
    kc, vc = (rs.randn(B, st, nkv, HD) for _ in range(2))
    tk, tv = _t(kc, dtype), _t(vc, dtype)
    k_before = tk.clone()
    ctx, k_out, v_out = tfd.attend_cache_append(
        _t(q, dtype), _t(kn, dtype), _t(vn, dtype), tk, tv, pos)
    jargs = [_j(a, dtype) for a in (q, kn, vn, kc, vc)]
    want = jfd.attend_cache_append(*jargs, jnp.int32(pos))
    ref = jfd._attend_reference(*jargs, jnp.int32(pos), 1.0 / np.sqrt(HD))
    for g, w, r, name in zip((ctx, k_out, v_out), want, ref,
                             ("ctx", "k_cache", "v_cache")):
        _close(g, w, dtype, f"{name} vs the Pallas kernel")
        _close(g, r, dtype, f"{name} vs the JAX reference")
    # in place: the returned caches are the tensors passed in, with the new
    # row at pos and every other row untouched
    assert k_out is tk and v_out is tv
    assert torch.equal(tk[:, pos], _t(kn, dtype))
    assert torch.equal(tv[:, pos], _t(vn, dtype))
    rows = [t for t in range(st) if t != pos]
    assert torch.equal(tk[:, rows], k_before[:, rows])


# ---------------------------------------------------------------------------
# K6c: norm + MLP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind,act", [("layer_norm", "gelu_tanh"),
                                      ("layer_norm", "gelu"),
                                      ("rms_norm", "silu"),
                                      ("rms_norm", "gelu_tanh")])
def test_norm_mlp_matches_jax_kernel(interpret, dtype, kind, act):
    inter = 64
    rs = np.random.RandomState(13)
    x = rs.randn(B, H) * 2 + 0.3
    nw = rs.rand(H) + 0.5
    nb = rs.randn(H) * 0.1 if kind == "layer_norm" else None
    w1 = rs.randn(H, inter) / np.sqrt(H)
    w2 = rs.randn(inter, H) / np.sqrt(inter)
    ln = kind == "layer_norm"
    b1 = rs.randn(inter) * 0.1 if ln else None
    b2 = rs.randn(H) * 0.1 if ln else None
    wg = None if ln else rs.randn(H, inter) / np.sqrt(H)
    arrays = dict(norm_w=nw, norm_b=nb, w1=w1, b1=b1, w2=w2, b2=b2,
                  w_gate=wg)
    eps = 1e-5 if ln else 1e-6
    got = tfd.norm_mlp(_t(x, dtype), kind=kind, eps=eps, act=act,
                       **{k: None if v is None else _t(v, dtype)
                          for k, v in arrays.items()})
    jarr = {k: None if v is None else _j(v, dtype)
            for k, v in arrays.items()}
    want = jfd.norm_mlp(_j(x, dtype), kind=kind, eps=eps, act=act, **jarr)
    ref = jfd._norm_mlp_reference(
        _j(x, dtype), kind, jarr["norm_w"], jarr["norm_b"], jarr["w1"],
        jarr["b1"], jarr["w2"], jarr["b2"], jarr["w_gate"], eps, act)
    assert got.shape == (B, H)
    _close(got, want, dtype, "vs the Pallas kernel")
    _close(got, ref, dtype, "vs the JAX reference")


@pytest.mark.parametrize("dtype", DTYPES)
def test_reference_rms_norm_casts_the_rsqrt_back_first(dtype):
    """The decode step's RMSNorm is the JAX ``reference_rms_norm`` (rsqrt
    rounded to the input dtype before the weight multiply): equal to it in
    each dtype."""
    rs = np.random.RandomState(2)
    x, w = rs.randn(5, H) * 3, rs.rand(H) + 0.5
    got = tfd.reference_rms_norm(_t(x, dtype), _t(w, dtype), 1e-5)
    want = jfd.reference_rms_norm(_j(x, dtype), _j(w, dtype), 1e-5)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), _np(want),
                               rtol=F32_TOL if dtype == "float32" else 1e-2,
                               atol=F32_TOL)


# ---------------------------------------------------------------------------
# the card's gate and the CPU route
# ---------------------------------------------------------------------------

def test_norm_mlp_row_gate():
    """At most NORM_MLP_MAX_ROWS (64) rows go to K6c; more take the
    torch.matmul composition.  One dtype and contiguous weight columns
    are needed; no byte budget applies."""
    w1, w2 = torch.zeros(H, 64), torch.zeros(64, H)
    assert tfd.NORM_MLP_MAX_ROWS == 64
    assert tfd.norm_mlp_admits(torch.zeros(64, H), w1, w2)
    assert tfd.norm_mlp_admits(torch.zeros(1, H), w1, w2, w1)
    assert not tfd.norm_mlp_admits(torch.zeros(65, H), w1, w2)
    assert not tfd.norm_mlp_admits(torch.zeros(8, H), w1.double(), w2)
    assert not tfd.norm_mlp_admits(torch.zeros(8, H), w1, w2.t().t()[:, ::2])
    big = torch.empty(4096, 11008)            # 180 MB: past the TPU's 10 MiB
    assert tfd.norm_mlp_admits(torch.zeros(8, 4096), big,
                               torch.empty(11008, 4096), big)


def test_rope_qkv_and_attend_gates():
    x = torch.zeros(2, H)
    w = torch.zeros(H, 4 * HD)
    wkv = torch.zeros(H, 2 * HD)
    assert tfd.rope_qkv_admits(x, w, wkv, wkv, 4, 2, HD)
    assert not tfd.rope_qkv_admits(x, w, wkv, wkv, 4, 3, HD)   # nh % nkv
    assert not tfd.rope_qkv_admits(torch.zeros(2, 35), torch.zeros(35, 28),
                                   torch.zeros(35, 14), torch.zeros(35, 14),
                                   4, 2, 7)                  # odd head dim
    packed = torch.zeros(H, 3 * 4 * HD)      # GPT's q/k/v: column slices
    assert tfd.rope_qkv_admits(x, packed[:, :32], packed[:, 32:64],
                               packed[:, 64:], 4, 4, HD)
    q = torch.zeros(2, 8, 128)
    cache = torch.zeros(2, 16, 1, 128)
    assert tfd.attend_admits(q, cache, cache)
    assert not tfd.attend_admits(torch.zeros(2, 16, 128), cache, cache)
    assert not tfd.attend_admits(torch.zeros(2, 1, 512),
                                 torch.zeros(2, 16, 1, 512),
                                 torch.zeros(2, 16, 1, 512))
    assert not tfd.attend_admits(q, cache.transpose(1, 2), cache)


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    before = dict(tfd.launches)
    x = torch.randn(2, H)
    w = torch.randn(H, 4 * HD)
    q, k, v = tfd.rope_qkv(x, w, w, w, n_heads=4, n_kv=4, head_dim=HD)
    tfd.attend_cache_append(q, k, v, torch.zeros(2, 6, 4, HD),
                            torch.zeros(2, 6, 4, HD), 2)
    tfd.norm_mlp(x, kind="rms_norm", norm_w=torch.ones(H), w1=w, w2=w.t(),
                 w_gate=w)
    assert tfd.launches == before
    with pytest.raises(ValueError, match="unknown norm kind"):
        tfd.norm_mlp(x, kind="batch_norm", norm_w=torch.ones(H), w1=w,
                     w2=w.t())
    with pytest.raises(ValueError, match="unsupported device"):
        tfd.rope_qkv(x.to("meta"), w, w, w, n_heads=4, n_kv=4, head_dim=HD)


def test_jax_gumbel_is_what_categorical_adds():
    """The port's sampler feeds JAX's own Gumbel noise in the tests of
    ``test_torch_decode_loop.py``: check here that ``categorical`` is
    ``argmax(logits + gumbel(key))`` on this JAX."""
    key = jax.random.PRNGKey(3)
    logits = jnp.asarray(np.random.RandomState(1).randn(4, 50), jnp.float32)
    g = jax.random.gumbel(key, logits.shape, jnp.float32)
    np.testing.assert_array_equal(
        np.asarray(jax.random.categorical(key, logits, axis=-1)),
        np.asarray(jnp.argmax(logits + g, axis=-1)))


# ---------------------------------------------------------------------------
# K6c's stream route on the card: its rule and its plans
# ---------------------------------------------------------------------------

# K6c's main-path calls (phase 9 of chip_smoke.py: the decode loops' and
# serving's decode-only steps): name: (rows, H, I, gated, dtype)
K6C_MAIN_PATH = {
    "llama": (8, 4096, 11008, True, torch.float32),
    "gpt": (8, 2048, 8192, False, torch.float32),
    "bf16": (8, 4096, 11008, True, torch.bfloat16),
    "rows33": (33, 2048, 8192, False, torch.float32),
    "rows64": (64, 4096, 11008, True, torch.float32),
}


def _meta_mlp(rows, h, inter, gated, dtype):
    def m(*shape):
        return torch.empty(*shape, dtype=dtype, device="meta")
    return m(rows, h), m(h, inter), m(inter, h), m(h, inter) if gated \
        else None


@pytest.mark.parametrize("name", list(K6C_MAIN_PATH))
def test_norm_mlp_main_path_shapes_take_the_stream_route(name):
    x, w1, w2, wg = _meta_mlp(*K6C_MAIN_PATH[name])
    assert tfd.norm_mlp_admits(x, w1, w2, wg)
    assert tfd.norm_mlp_route(x, w1, w2, wg) == "stream"


def test_norm_mlp_odd_widths_and_views_take_the_generic_route():
    """Both launches go generic where either product is off the rule: an
    odd intermediate size, an unaligned weight view, a bf16 width that is
    not a multiple of 8."""
    x = torch.zeros(8, 64)
    assert tfd.norm_mlp_route(x, torch.zeros(64, 96),
                              torch.zeros(96, 64)) == "stream"
    assert tfd.norm_mlp_route(x, torch.zeros(64, 97),
                              torch.zeros(97, 64)) == "generic"
    w1 = torch.zeros(64 * 96 + 1)[1:].view(64, 96)
    assert tfd.norm_mlp_route(x, w1, torch.zeros(96, 64)) == "generic"
    xb = torch.zeros(8, 64, dtype=torch.bfloat16)
    assert tfd.norm_mlp_route(
        xb, torch.zeros(64, 100, dtype=torch.bfloat16),
        torch.zeros(100, 64, dtype=torch.bfloat16)) == "generic"


@pytest.mark.parametrize("blocks", [132, 264, 3, 131])
@pytest.mark.parametrize("name", list(K6C_MAIN_PATH))
def test_norm_mlp_plans_cover_both_launches(name, blocks):
    """The up (and gate) launch deals its n_up x ceil(I / tile) tiles'
    steps out, the down launch its ceil(H / tile) tiles' steps over I;
    each covers every unit once with shares differing by at most one."""
    rows, h, inter, gated, dtype = K6C_MAIN_PATH[name]
    tn, ks = tfd.stream_geometry(False, dtype.itemsize)
    for tiles, k in (((1 + gated) * -(-inter // tn), h),
                     (-(-h // tn), inter)):
        plan = tfd.stream_plan(tiles, -(-k // ks), blocks)
        shares = tfd.stream_shares(plan)
        assert shares[0][0] == 0 and shares[-1][1] == tiles * plan.ksteps
        assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
        lengths = [e - s for s, e in shares]
        assert max(lengths) - min(lengths) <= 1
