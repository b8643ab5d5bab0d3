"""The PyTorch port's ragged paged attention (paddle_tpu_torch.ops) held
against the JAX package on the CPU: its plain version against both the
JAX reference and the JAX Pallas kernel in interpret mode, on the same
numpy inputs.

Tolerance: rtol = atol = 2e-5 (fp32 on every side; the three compute
the same masked softmax with sums in different orders — XLA's dot vs
torch's einsum, and the Pallas kernel's page-by-page online softmax —
which moves results by a few ulps of values of order 1).  The padding
row of an empty slot must be exactly 0 on every side.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.flags import get_flags, set_flags
from paddle_tpu.ops.pallas import ragged_paged_attention as jrpa
from paddle_tpu_torch.ops import ragged_paged_attention as trpa

RTOL = ATOL = 2e-5
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _case(rs, nh, nkv, b=4, qw=8, hd=16, ps=4, ppseq=6, p_total=32):
    """The mixed batch of tests/test_serving.py: a full prefill, a
    decode, an empty padding slot and a mid-chunk."""
    q = rs.randn(b, qw, nh, hd).astype("float32")
    kp = rs.randn(nkv, p_total, ps, hd).astype("float32")
    vp = rs.randn(nkv, p_total, ps, hd).astype("float32")
    kv_lens = np.array([13, 1, 0, 24], "int32")
    q_lens = np.array([8, 1, 0, 3], "int32")
    tables = rs.permutation(p_total)[:b * ppseq].reshape(b, ppseq) \
        .astype("int32")
    return q, kp, vp, kv_lens, q_lens, tables


@pytest.fixture
def interpret():
    keep = get_flags(["FLAGS_pallas_interpret"])
    set_flags({"FLAGS_pallas_interpret": True})
    yield
    set_flags(keep)


@pytest.mark.parametrize("nh,nkv", [(4, 4), (4, 2)], ids=["mha", "gqa"])
def test_plain_version_matches_jax_reference_and_kernel(interpret, nh, nkv):
    arrs = _case(np.random.RandomState(0), nh, nkv)
    port = trpa.ragged_paged_attention_ref(
        *(torch.from_numpy(a) for a in arrs)).numpy()
    jref = np.asarray(jrpa.ragged_paged_attention_ref(
        *(jnp.asarray(a) for a in arrs)))
    # FLAGS_pallas_interpret routes this through the Pallas kernel
    jker = np.asarray(jrpa.ragged_paged_attention(
        *(jnp.asarray(a) for a in arrs)))
    q_lens = arrs[4]
    for b in range(len(q_lens)):
        n = int(q_lens[b])
        np.testing.assert_allclose(port[b, :n], jref[b, :n],
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(port[b, :n], jker[b, :n],
                                   rtol=RTOL, atol=ATOL)
    # padding rows stay finite; the empty slot's rows are exactly zero
    assert np.isfinite(port).all()
    assert np.all(port[2] == 0.0) and np.all(jker[2] == 0.0)


NEG = -1e30


def _split_states(q, kp, vp, kv_lens, q_lens, tables, pages):
    """The kernel's page splits in plain torch: each row's positions cut
    into runs of ``pages`` pages, and each run's fp32 online-softmax
    state over the positions the row attends: (m, l, acc), with m =
    -1e30, l = 0, acc = 0 for a run it attends none of.  Returns
    m, l [S, B, Q, nh] and acc [S, B, Q, nh, hd]."""
    b, qw, nh, hd = q.shape
    nkv, _, ps, _ = kp.shape
    rep = nh // nkv
    t = tables.shape[1] * ps
    tbl = tables.long()
    k = kp[:, tbl].transpose(0, 1).reshape(b, nkv, t, hd)
    v = vp[:, tbl].transpose(0, 1).reshape(b, nkv, t, hd)
    k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    s = torch.einsum("bqhd,bhtd->bqht", q.float(), k.float()) / hd ** 0.5
    pos = torch.arange(t)
    qpos = (kv_lens - q_lens)[:, None] + torch.arange(qw)[None]
    seen = (pos[None, None] <= qpos[..., None]) \
        & (pos[None, None] < kv_lens[:, None, None])          # [B, Q, T]
    seen = seen[:, :, None].expand(s.shape)
    run = pages * ps
    states = []
    for lo in range(0, t, run):
        sl, ok = s[..., lo:lo + run], seen[..., lo:lo + run]
        m = torch.where(ok, sl, torch.tensor(NEG)).amax(-1)
        p = torch.where(ok, torch.exp(sl - m[..., None]), torch.tensor(0.0))
        acc = torch.einsum("bqht,bhtd->bqhd", p, v[:, :, lo:lo + run].float())
        states.append((m, p.sum(-1), acc))
    return tuple(torch.stack(x) for x in zip(*states))


def _merge_in_split_order(m, l, acc):
    """The last block's merge: the splits' states in split order, rescaled
    to their common max; a row whose splits are all empty is 0."""
    mx = m.amax(0)
    den = torch.zeros_like(mx)
    num = torch.zeros_like(acc[0])
    for z in range(m.shape[0]):
        f = torch.exp(m[z] - mx)
        den = den + l[z] * f
        num = num + acc[z] * f[..., None]
    safe = torch.where(den > 0, den, torch.ones_like(den))
    return torch.where(den[..., None] > 0, num / safe[..., None],
                       torch.zeros_like(num))


@pytest.mark.parametrize("pages", [1, 2, 4])
@pytest.mark.parametrize("nh,nkv", [(4, 4), (4, 2)], ids=["mha", "gqa"])
def test_page_split_merge_matches_references(nh, nkv, pages):
    """K7's split over pages, modelled on the mixed batch: runs of 1, 2
    and 4 pages merged in split order equal the port's plain version and
    the JAX reference (RTOL / ATOL) on every live row.  Runs a row does
    not attend publish exactly (-1e30, 0, 0), and the empty slot, whose
    every run is empty, merges to exactly 0; nothing is NaN."""
    arrs = _case(np.random.RandomState(5), nh, nkv)
    t = [torch.from_numpy(a) for a in arrs]
    m, l, acc = _split_states(*t, pages)
    got = _merge_in_split_order(m, l, acc).numpy()
    port = trpa.ragged_paged_attention_ref(*t).numpy()
    jref = np.asarray(jrpa.ragged_paged_attention_ref(
        *(jnp.asarray(a) for a in arrs)))
    for b, n in enumerate(arrs[4]):
        np.testing.assert_allclose(got[b, :n], port[b, :n], rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(got[b, :n], jref[b, :n], rtol=RTOL,
                                   atol=ATOL)
    empty = l == 0
    assert empty.any() and (~empty).any()
    assert torch.all(m[empty] == NEG)
    assert torch.all(acc[empty] == 0)
    assert np.isfinite(got).all()
    assert torch.all(empty[:, 2]) and np.all(got[2] == 0.0)


def test_plain_version_bf16_keeps_dtype_and_fp32_statistics():
    arrs = list(_case(np.random.RandomState(1), 4, 2))
    t = [torch.from_numpy(a) for a in arrs]
    want = trpa.ragged_paged_attention_ref(*t)
    t[0] = t[0].bfloat16()
    got = trpa.ragged_paged_attention_ref(*t)
    assert got.dtype == torch.bfloat16
    for b, n in enumerate(arrs[4]):
        # bf16 inputs round q to 8 mantissa bits; output rounds again
        np.testing.assert_allclose(got[b, :n].float().numpy(),
                                   want[b, :n].numpy(), atol=3e-2)


def test_append_positions_matches_jax():
    rs = np.random.RandomState(2)
    kv_lens = np.array([5, 40, 17, 8], "int32")    # lane 1 is dead and
    tables = rs.randint(0, 31, (4, 6)).astype("int32")   # past its table
    live = np.array([True, False, True, True])
    want = jrpa.append_positions(jnp.asarray(kv_lens), jnp.asarray(tables),
                                 jnp.asarray(live), 4, 31)
    got = trpa.append_positions(torch.from_numpy(kv_lens),
                                torch.from_numpy(tables),
                                torch.from_numpy(live), 4, 31)
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def test_cpu_wrapper_takes_plain_route_without_launching():
    arrs = [torch.from_numpy(a)
            for a in _case(np.random.RandomState(3), 4, 2)]
    before = trpa.launches
    out = trpa.ragged_paged_attention(*arrs)
    assert trpa.launches == before
    assert torch.equal(out, trpa.ragged_paged_attention_ref(*arrs))


def test_wrapper_refuses_other_devices():
    arrs = [torch.from_numpy(a)
            for a in _case(np.random.RandomState(4), 4, 2)]
    with pytest.raises(ValueError, match="unsupported device"):
        trpa.ragged_paged_attention(arrs[0].to("meta"), *arrs[1:])


def test_importing_ops_needs_no_nvcc_and_no_gpu():
    code = ("import paddle_tpu_torch.ops as o\n"
            "from paddle_tpu_torch.ops import _build\n"
            "assert not _build._libs and not _build.build_log\n"
            "print('ok')\n")
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_VISIBLE_DEVICES="",
               CUDA_HOME="/nonexistent")
    res = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
