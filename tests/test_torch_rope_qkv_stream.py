"""K6a's stream form (``csrc/fused_decode.cu`` ``qkv_stream_kernel``)
modelled on the CPU, where no card runs it:

* its route (``rope_qkv_route``, the twin of the kernel's
  ``fd_qkv_route``) on phase 9's main-path shapes and on the shapes it
  leaves to the generic GEMV;
* its plan over q's, k's and v's tiles: every (tile, step) unit once, each
  share within the work buffer's slots;
* a torch model of its epilogue: which lane leaves which sum, and which
  column pair (interleaved ``(2i, 2i + 1)`` or neox ``(j, j + hd/2)``)
  inside a tile each output thread rotates, held against the JAX Pallas
  kernel in interpret mode at 2e-5;
* a numpy model of its bf16 tensor-core loop: the swizzled stage, the
  ``ldmatrix.trans`` A fragments, the ``ldmatrix`` B fragments of x's
  window and the ``mma.m16n8k16`` accumulators as PTX defines them, the
  sums scattered to the work buffer and the same epilogue, held against
  the JAX kernel within the bf16 tolerance 2e-2.

Shapes are meta tensors for the route (no bytes), tiny for the models.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.flags import get_flags, set_flags
from paddle_tpu.ops.pallas import fused_decode as jfd
from paddle_tpu_torch.ops import fused_decode as tfd

F32_TOL = 2e-5
BF16_TOL = 2e-2
WARPS = 8


@pytest.fixture
def interpret():
    keep = get_flags(["FLAGS_pallas_interpret"])
    set_flags({"FLAGS_pallas_interpret": True})
    yield
    set_flags(keep)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


# phase 9's cases (chip_smoke.K6A_CASES): (hidden, nh, nkv, neox, dtype,
# packed: GPT's q/k/v are column slices of its [H, 3H] projection)
HD = 128
PHASE9 = {
    "llama": (4096, 32, 32, False, torch.float32, False),
    "gpt": (2048, 16, 16, False, torch.float32, True),
    "gqa": (4096, 32, 8, False, torch.float32, False),
    "neox": (4096, 32, 32, True, torch.float32, False),
    "bf16": (4096, 32, 32, False, torch.bfloat16, False),
}
# every main-path case takes the stream form (GPT's 50 MB product too)
WANT = {"llama": "stream", "gpt": "stream", "gqa": "stream",
        "neox": "stream", "bf16": "stream"}


def _weights(h, nq, nk, dtype, packed):
    if packed:
        w = _meta(h, nq + 2 * nk, dtype=dtype)
        return w[:, :nq], w[:, nq:nq + nk], w[:, nq + nk:]
    return tuple(_meta(h, n, dtype=dtype) for n in (nq, nk, nk))


@pytest.mark.parametrize("name", list(PHASE9))
def test_rope_qkv_route_on_the_main_path_shapes(name):
    h, nh, nkv, neox, dtype, packed = PHASE9[name]
    x = _meta(8, h, dtype=dtype)
    wq, wk, wv = _weights(h, nh * HD, nkv * HD, dtype, packed)
    assert tfd.rope_qkv_admits(x, wq, wk, wv, nh, nkv, HD)
    assert tfd.rope_qkv_route(x, wq, wk, wv, HD, neox) == WANT[name]


@pytest.mark.parametrize("what,rows,h,nq,nk,hd,neox,dtype,want", [
    ("llama at one row", 1, 4096, 4096, 4096, 128, False, torch.float32,
     "stream"),
    ("nine rows: past the window's 8", 9, 4096, 4096, 4096, 128, False,
     torch.float32, "generic"),
    ("odd width", 8, 64, 6, 6, 2, False, torch.float32, "generic"),
    ("bf16 width not a multiple of 8", 8, 64, 4, 4, 2, False,
     torch.bfloat16, "generic"),
    ("odd hidden", 8, 63, 64, 64, 32, False, torch.float32, "generic"),
    ("neox pairs across an fp32 tile (hd 256 > 128 columns)", 8, 512,
     512, 512, 256, True, torch.float32, "generic"),
    ("interleaved pairs at hd 256 stay in a tile", 8, 512, 512, 512, 256,
     False, torch.float32, "stream"),
    ("neox hd 256 fits a bf16 tile of 256 columns", 8, 512, 512, 512, 256,
     True, torch.bfloat16, "stream"),
    ("neox hd 96 does not divide 128 columns", 8, 512, 384, 384, 96, True,
     torch.float32, "generic"),
    ("fp32 window of all of K at the budget", 8, 5728, 4096, 4096, 128,
     False, torch.float32, "stream"),
    ("fp32 window of all of K past the budget", 8, 5760, 4096, 4096, 128,
     False, torch.float32, "generic"),
    ("fp16", 8, 64, 64, 64, 32, False, torch.float16, "generic"),
])
def test_rope_qkv_route_rule(what, rows, h, nq, nk, hd, neox, dtype, want):
    x = _meta(rows, h, dtype=dtype)
    wq, wk, wv = _weights(h, nq, nk, dtype, False)
    assert tfd.rope_qkv_route(x, wq, wk, wv, hd, neox) == want, what


def test_rope_qkv_route_unaligned_views_take_the_generic_gemv():
    """A weight view 4 bytes off 16-byte alignment, and a non-contiguous
    x, are off the rule."""
    x = torch.zeros(8, 64)
    w = torch.zeros(64, 64)
    assert tfd.rope_qkv_route(x, w, w, w, 32, False) == "stream"
    off = torch.zeros(64 * 64 + 1)[1:].view(64, 64)
    assert tfd.rope_qkv_route(x, off, w, w, 32, False) == "generic"
    assert tfd.rope_qkv_route(x, w, w, off, 32, False) == "generic"
    xt = torch.zeros(64, 8).t()
    assert tfd.rope_qkv_route(xt, w, w, w, 32, False) == "generic"
    # a packed projection's slices keep the stream form (row stride 3 n)
    p = torch.zeros(64, 192)
    assert tfd.rope_qkv_route(x, p[:, :64], p[:, 64:128], p[:, 128:], 32,
                              False) == "stream"


# ---------------------------------------------------------------------------
# the plan over three problems
# ---------------------------------------------------------------------------

def _unit_owner(tiles_of, ksteps, unit):
    """(problem, tile in it, step) of a unit, as ``tile_problem`` deals
    the launch's tiles: q's, then k's, then v's."""
    t, s = divmod(unit, ksteps)
    for pi, n in enumerate(tiles_of):
        if t < n or pi == len(tiles_of) - 1:
            return pi, t, s
        t -= n


@pytest.mark.parametrize("blocks", [132, 264, 3, 131])
@pytest.mark.parametrize("name", list(PHASE9))
def test_qkv_plan_covers_every_unit_of_q_k_and_v_once(name, blocks):
    h, nh, nkv, _, dtype, _ = PHASE9[name]
    tn, ks = tfd.stream_geometry(False, dtype.itemsize)
    tiles_of = [-(-n * HD // tn) for n in (nh, nkv, nkv)]
    plan = tfd.stream_plan(sum(tiles_of), -(-h // ks), blocks)
    shares = tfd.stream_shares(plan)
    seen = set()
    slots = -(-(plan.q + 1) // plan.ksteps) + 1   # the work buffer's
    for start, end in shares:
        owners = [_unit_owner(tiles_of, plan.ksteps, u)
                  for u in range(start, end)]
        seen.update(owners)
        assert len({u // plan.ksteps for u in range(start, end)}) <= slots
    want = {(pi, t, s) for pi, n in enumerate(tiles_of) for t in range(n)
            for s in range(plan.ksteps)}
    assert seen == want and sum(e - s for s, e in shares) == len(want)
    lengths = [e - s for s, e in shares]
    assert max(lengths) - min(lengths) <= 1
    # a cut tile's parts: every block whose share touches it, block order
    for t in range(plan.tiles):
        blocks_on = [j for j, (s, e) in enumerate(shares)
                     if s < (t + 1) * plan.ksteps and e > t * plan.ksteps]
        assert [j for j, _ in tfd.stream_contributors(plan, t)] == blocks_on


# ---------------------------------------------------------------------------
# the epilogue: lanes' sums into the part, then column pairs
# ---------------------------------------------------------------------------

def _pairs(tn, hd, neox_rope):
    """(c0, c1) of the output threads' pair index i, as ``publish`` maps
    them inside a tile of ``tn`` columns."""
    i = np.arange(tn // 2)
    if neox_rope:
        half = hd // 2
        c0 = (i // half) * hd + i % half
        return c0, c0 + half
    return 2 * i, 2 * i + 1


def _part_owners(dtype):
    """(row, column) of the tile's part each lane of each warp writes at a
    tile's end: fp32 lane (quad, chunk) after the butterfly row ``quad``,
    columns 16 w + 4 chunk .. + 3; bf16 the m16n8k16 accumulators, e of
    m-tile mt: column 32 w + 16 mt + lane / 4 (+ 8 for e >= 2), row
    2 (lane % 4) + e % 2."""
    owners = []
    for w in range(WARPS):
        for lane in range(32):
            quad, chunk = lane // 4, lane % 4
            if dtype == torch.float32:
                owners += [(quad, 16 * w + 4 * chunk + c) for c in range(4)]
            else:
                owners += [(2 * chunk + e % 2,
                            32 * w + 16 * mt + quad + 8 * (e // 2))
                           for mt in range(2) for e in range(4)]
    return owners


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lanes_leave_every_sum_of_a_tile_once(dtype):
    tn, _ = tfd.stream_geometry(False, dtype.itemsize)
    owners = _part_owners(dtype)
    assert len(owners) == len(set(owners)) == 8 * tn


@pytest.mark.parametrize("tn", [128, 256])
@pytest.mark.parametrize("hd,neox", [(8, False), (8, True), (32, True),
                                     (128, True), (128, False)])
def test_column_pairs_lie_inside_a_tile_and_cover_it(tn, hd, neox):
    c0, c1 = _pairs(tn, hd, neox)
    cols = np.concatenate([c0, c1])
    assert cols.max() < tn and sorted(cols) == list(range(tn))
    # partners are one head's rotation partners
    assert ((c0 // hd) == (c1 // hd)).all()
    assert ((c1 - c0) == (hd // 2 if neox else 1)).all()


def _epilogue(sums, bias, cos, sin, hd, neox, tn):
    """The stream form's publish on one problem's fp32 sums [B, n]: tile
    by tile, each pair's bias, then its rotation by the cos/sin row."""
    b, n = sums.shape
    out = torch.full_like(sums, float("nan"))
    rope = cos is not None
    c0, c1 = _pairs(tn, hd, neox and rope)
    for n0 in range(0, n, tn):
        m0, m1 = n0 + c0, n0 + c1
        keep = m1 < n
        m0, m1 = torch.tensor(m0[keep]), torch.tensor(m1[keep])
        v0, v1 = sums[:, m0], sums[:, m1]
        if bias is not None:
            v0, v1 = v0 + bias[m0], v1 + bias[m1]
        if rope:
            d0, d1 = m0 % hd, m1 % hd
            v0, v1 = (v0 * cos[d0] - v1 * sin[d0],
                      v1 * cos[d1] + v0 * sin[d1])
        out[:, m0], out[:, m1] = v0, v1
    assert not out.isnan().any()
    return out


def _rope_row(rs, hd, neox):
    ang = rs.rand(hd // 2).astype(np.float32) * 3
    full = np.concatenate([ang, ang]) if neox else np.repeat(ang, 2)
    return np.cos(full), np.sin(full)


def _inputs(seed, b, h, nh, nkv, hd, rope, bias):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, h).astype(np.float32)
    ws = [(rs.randn(h, n * hd) / np.sqrt(h)).astype(np.float32)
          for n in (nh, nkv, nkv)]
    bs = [(rs.randn(n * hd) * 0.1).astype(np.float32) if bias else None
          for n in (nh, nkv, nkv)]
    cs = _rope_row(rs, hd, rope == "neox") if rope else (None, None)
    return x, ws, bs, cs


def _jax_kernel(x, ws, bs, cs, nh, nkv, hd, neox, dtype):
    jd = getattr(jnp, dtype)

    def j(a, d=jd):
        return None if a is None else jnp.asarray(a).astype(d)
    return [np.asarray(o.astype(jnp.float32)) for o in jfd.rope_qkv(
        j(x), *(j(w) for w in ws), *(j(b) for b in bs),
        *(j(c, jnp.float32) for c in cs), n_heads=nh, n_kv=nkv,
        head_dim=hd, neox=neox)]


@pytest.mark.parametrize("rope,bias,hd,nh,nkv", [
    ("interleaved", False, 32, 8, 4),
    ("neox", False, 32, 8, 4),
    ("neox", True, 64, 4, 2),
    (None, True, 32, 4, 4),
])
def test_epilogue_model_matches_the_jax_kernel(interpret, rope, bias, hd,
                                               nh, nkv):
    """fp32: the pair epilogue on the sums x @ w (the JAX kernel's fp32
    dots) equals the JAX kernel's ``_rope_flat`` output."""
    b, h = 3, 48
    x, ws, bs, (cos, sin) = _inputs(5, b, h, nh, nkv, hd, rope, bias)
    neox = rope == "neox"
    want = _jax_kernel(x, ws, bs, (cos, sin), nh, nkv, hd, neox, "float32")
    tn, _ = tfd.stream_geometry(False, 4)
    t = (lambda a: None if a is None else torch.from_numpy(a))
    for pi, (w, bb) in enumerate(zip(ws, bs)):
        got = _epilogue(t(x) @ t(w), t(bb), t(cos) if pi < 2 else None,
                        t(sin) if pi < 2 else None, hd, neox, tn)
        np.testing.assert_allclose(got.numpy(), want[pi].reshape(b, -1),
                                   rtol=F32_TOL, atol=F32_TOL)


# ---------------------------------------------------------------------------
# the bf16 tensor-core loop
# ---------------------------------------------------------------------------

def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _swizzled(row, chunk):
    """Byte offset in a warp's 32 x 64-byte part of a stage (the kernel's
    ``swizzled``)."""
    return row * 64 + 16 * (chunk ^ ((row >> 1) & 3))


def _ldmatrix(mem, addrs, trans):
    """``ldmatrix.sync.aligned.m8n8.x4[.trans].b16``: ``mem`` a flat bf16
    array (as float), ``addrs[lane]`` the byte address of row lane % 8 of
    matrix lane / 8.  Returns regs[lane][i] = (lo, hi) of matrix i."""
    regs = np.zeros((32, 4, 2), np.float32)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for i in range(4):
            for e in range(2):
                if trans:   # element (row 2 t + e, column g)
                    at = addrs[8 * i + 2 * t + e] // 2 + g
                else:       # element (row g, column 2 t + e)
                    at = addrs[8 * i + g] // 2 + 2 * t + e
                regs[lane, i, e] = mem[at]
    return regs


def _mma(c, a, b0, b1):
    """``mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`` over a
    warp, from the PTX fragment layouts: A reg j holds (row g + 8 (j % 2),
    column 2 t + e + 8 (j / 2)); B reg j (b0, b1) holds (k 2 t + e + 8 j,
    column g); C element e holds (row g + 8 (e / 2), column 2 t + e % 2)."""
    A = np.zeros((16, 16), np.float32)
    B = np.zeros((16, 8), np.float32)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for j in range(4):
            for e in range(2):
                A[g + 8 * (j % 2), 2 * t + e + 8 * (j // 2)] = a[lane, j, e]
        for j, reg in enumerate((b0, b1)):
            for e in range(2):
                B[2 * t + e + 8 * j, g] = reg[lane, e]
    D = A.astype(np.float64) @ B.astype(np.float64)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for e in range(4):
            c[lane, e] += D[g + 8 * (e // 2), 2 * t + e % 2]


def _bf16_sums(x, w):
    """One problem's fp32 sums [8, n] of bf16 x [b, k] against bf16 w [k,
    n] the way the kernel's warps make them: each 32-row step of a
    256-column tile copied lane by lane into the swizzled stage, read back
    by ldmatrix.trans, x's window rows by ldmatrix, then mma; the
    accumulators scattered to the part [8][256] at a tile's end."""
    b, k = x.shape
    n = w.shape[1]
    tn, ks = 256, 32
    steps = -(-k // ks)
    xw = np.zeros((8, steps * ks), np.float32)
    xw[:b, :k] = x
    stride = steps * ks * 2 + 16                  # the window's row bytes
    xmem = np.zeros(8 * stride // 2, np.float32)
    for r in range(8):
        xmem[r * stride // 2: r * stride // 2 + steps * ks] = xw[r]
    wp = np.zeros((steps * ks, -(-n // tn) * tn), np.float32)
    wp[:k, :n] = w
    out = np.zeros((8, wp.shape[1]), np.float32)
    for n0 in range(0, wp.shape[1], tn):
        part = np.full((8, tn), np.nan, np.float32)
        for warp in range(WARPS):
            acc = np.zeros((2, 32, 4), np.float64)
            for s in range(steps):
                stage = np.zeros(2048 // 2, np.float32)   # the warp's part
                for lane in range(32):
                    quad, chunk = lane // 4, lane % 4
                    for r in range(4):
                        row = 4 * quad + r
                        col = n0 + 32 * warp + 8 * chunk
                        at = _swizzled(row, chunk) // 2
                        stage[at:at + 8] = wp[s * ks + row, col:col + 8]
                xb = _ldmatrix(xmem, [(lane % 8) * stride + 16 * (lane // 8)
                                      + s * ks * 2 for lane in range(32)],
                               False)
                for mt in range(2):
                    for h in range(2):
                        addrs = [_swizzled(16 * h + 8 * ((ln // 8) >> 1)
                                           + ln % 8,
                                           2 * mt + ((ln // 8) & 1))
                                 for ln in range(32)]
                        af = _ldmatrix(stage, addrs, True)
                        _mma(acc[mt], af, xb[:, 2 * h], xb[:, 2 * h + 1])
            for lane in range(32):
                quad, chunk = lane // 4, lane % 4
                for mt in range(2):
                    for e in range(4):
                        col = 32 * warp + 16 * mt + quad + 8 * (e // 2)
                        part[2 * chunk + e % 2, col] = acc[mt, lane, e]
        out[:, n0:n0 + tn] = part
    return torch.from_numpy(out[:b, :n])


def test_bf16_fragment_model_reads_the_weight_and_x_exactly():
    """The swizzled stage and the ldmatrix addresses give back exactly
    x @ w in fp32 on bf16 values (small integers: every sum is exact)."""
    rs = np.random.RandomState(0)
    x = rs.randint(-3, 4, (8, 64)).astype(np.float32)
    w = rs.randint(-3, 4, (64, 256)).astype(np.float32)
    np.testing.assert_array_equal(_bf16_sums(x, w).numpy(), x @ w)


@pytest.mark.parametrize("rope,bias,hd,nh,nkv,b", [
    ("interleaved", False, 32, 8, 4, 8),
    ("neox", False, 64, 4, 2, 8),
    (None, True, 32, 8, 8, 5),
])
def test_bf16_fragment_model_matches_the_jax_kernel(interpret, rope, bias,
                                                    hd, nh, nkv, b):
    """bf16: the fragment model's sums, the pair epilogue and one rounding
    to bf16 against the JAX Pallas kernel (fp32 dots of the bf16 inputs,
    one rounding) within 2e-2."""
    h = 64
    x, ws, bs, (cos, sin) = _inputs(7, b, h, nh, nkv, hd, rope, bias)
    x, ws = _bf16(x), [_bf16(w) for w in ws]
    bs = [None if v is None else _bf16(v) for v in bs]
    neox = rope == "neox"
    want = _jax_kernel(x, ws, bs, (cos, sin), nh, nkv, hd, neox, "bfloat16")
    t = (lambda a: None if a is None else torch.from_numpy(a))
    for pi, (w, bb) in enumerate(zip(ws, bs)):
        sums = _bf16_sums(x, w)
        got = _epilogue(sums, t(bb), t(cos) if pi < 2 else None,
                        t(sin) if pi < 2 else None, hd, neox, 256)
        got = got.to(torch.bfloat16).float()
        np.testing.assert_allclose(got.numpy(), want[pi].reshape(b, -1),
                                   rtol=BF16_TOL, atol=BF16_TOL)
