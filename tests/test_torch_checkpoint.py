"""The port's ``distributed.checkpoint`` in one process, against the JAX
package's.

The JAX package's crash-safety scenarios (``tests/test_resilience.py``)
run in both packages on the same values — a ``Linear(3, 3)`` filled
with one value a version: a torn newest version, a digest swap, the
``ckpt_write=truncate`` fault, an async save failing at the join, an
async save committing at the join, ``keep_last_k``, the version
tie-break, an explicit version with a bad digest.  Held: the same
version is loaded, ``last_load_info()`` agrees in ``version``,
``committed``, ``metadata`` and the skipped versions' basenames, the
same warnings and errors are raised, the same version directories
survive GC, and the loaded values are exact.

Port-only: the overlap code on the layouts that cut tensors unevenly (a
packed ``[q | k | v]`` mp shard is three boxes; a ZeRO range cuts a row
in half) against numpy; an async save's snapshot (a later update does
not reach it); the optimizer's state keyed by parameter name; ``offload``;
the group / coordinator checks."""
import json
import os
import time
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.distributed as jdist
import paddle_tpu.nn as jnn
from paddle_tpu.resilience import faults as jfaults

import paddle_tpu_torch.distributed as pdist
from paddle_tpu_torch.distributed.checkpoint import pieces as pc
from paddle_tpu_torch.resilience import faults as pfaults

jck = jdist.checkpoint
pck = pdist.checkpoint


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv(jfaults.STATE_FILE_ENV, raising=False)
    jfaults.install_schedule(None)
    pfaults.install_schedule(None)
    yield
    jfaults.install_schedule(None)
    pfaults.install_schedule(None)


class _Jax:
    ck = jck

    @staticmethod
    def linear(value=None):
        m = jnn.Linear(3, 3)
        if value is not None:
            m.weight.set_value(jpaddle.full_like(m.weight, value))
            m.bias.set_value(jpaddle.full_like(m.bias, value))
        return m

    @staticmethod
    def weight(m):
        return np.asarray(m.weight.numpy())

    @staticmethod
    def schedule(text):
        jpaddle.set_flags({"FLAGS_fault_schedule": text})

    @staticmethod
    def fail_next_async(path, version, monkeypatch):
        """The JAX package's own injection: a pending save whose
        checkpointer dies at the join."""
        class _Failing:
            def wait_until_finished(self):
                raise RuntimeError("background save died")

            def close(self):
                pass
        dest = os.path.join(os.path.abspath(path), str(version))
        jck._ASYNC_SAVES[dest] = {"ckptr": _Failing(), "digests": {},
                                  "meta": None, "keep_last_k": None,
                                  "base": None}


class _Port:
    ck = pck

    @staticmethod
    def linear(value=None):
        m = torch.nn.Linear(3, 3)
        if value is not None:
            with torch.no_grad():
                m.weight.fill_(value)
                m.bias.fill_(value)
        return m

    @staticmethod
    def weight(m):
        return m.weight.detach().numpy().copy()

    @staticmethod
    def schedule(text):
        pfaults.install_schedule(text or None)

    @staticmethod
    def fail_next_async(path, version, monkeypatch):
        """A real async save whose background write raises."""
        def broken(dest, rank, pieces):
            raise RuntimeError("background save died")
        monkeypatch.setattr(pck, "_write_pieces", broken)
        pck.save_state_dict(_Port.linear(3.0).state_dict(), path,
                            unique_id=version, async_save=True)


PACKAGES = {"jax": _Jax, "port": _Port}


def _save(pkg, path, value, step, **kw):
    m = pkg.linear(value)
    pkg.ck.save_state_dict(m.state_dict(), path, unique_id=step,
                           metadata={"step": step}, **kw)
    return m


def _load(pkg, path, **kw):
    """Load into a fresh Linear: its weight, the load's info and the
    warnings raised (their messages)."""
    m = pkg.linear()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        pkg.ck.load_state_dict(m.state_dict(), path, **kw)
    info = pkg.ck.last_load_info()
    return pkg.weight(m), info, [str(r.message) for r in rec
                                 if issubclass(r.category, UserWarning)]


_KINDS = ("no _COMMIT", "failed digest", "failed to restore",
          "falling back")


def _summary(weight, info, msgs):
    return {"weight": weight.tolist(), "version": info["version"],
            "committed": info["committed"], "metadata": info["metadata"],
            "skipped": [os.path.basename(s) for s in info["skipped"]],
            "warnings": sorted({k for k in _KINDS
                                for m in msgs if k in m})}


def _both(tmp_path, scenario):
    out = {}
    for name, pkg in PACKAGES.items():
        out[name] = scenario(pkg, str(tmp_path / name / "ck"))
    assert out["port"] == out["jax"], out
    return out["port"]


def test_torn_newest_version_is_skipped(tmp_path):
    def run(pkg, path):
        _save(pkg, path, 1.0, 0)
        _save(pkg, path, 2.0, 1)
        os.remove(os.path.join(path, "1", pkg.ck.COMMIT_FILE))
        return _summary(*_load(pkg, path))
    got = _both(tmp_path, run)
    assert got["version"] == "0" and got["skipped"] == ["1"]
    assert got["weight"] == [[1.0] * 3] * 3
    assert got["warnings"] == ["no _COMMIT"]


def test_digest_swap_is_skipped_and_explicit_version_raises(tmp_path):
    def run(pkg, path):
        _save(pkg, path, 1.0, 0)
        _save(pkg, path, 2.0, 1)
        stale = open(os.path.join(path, "1", pkg.ck.COMMIT_FILE)).read()
        _save(pkg, path, 9.0, 1)
        with open(os.path.join(path, "1", pkg.ck.COMMIT_FILE), "w") as f:
            f.write(stale)
        got = _summary(*_load(pkg, path))
        with pytest.raises(ValueError, match="digest"):
            pkg.ck.load_state_dict(pkg.linear().state_dict(), path,
                                   unique_id=1)
        return got
    got = _both(tmp_path, run)
    assert got["version"] == "0" and got["skipped"] == ["1"]
    assert got["warnings"] == ["failed digest"]
    assert got["weight"] == [[1.0] * 3] * 3


def test_ckpt_write_truncate_fault(tmp_path):
    """The fault damages the newest save in the torn window; both loads
    skip it with a warning and read version 0 (the JAX package's orbax
    files fail to restore or to verify, the port's data file is short:
    the kinds of warning are each package's own)."""
    out = {}
    for name, pkg in PACKAGES.items():
        path = str(tmp_path / name / "ck")
        _save(pkg, path, 1.0, 0)
        pkg.schedule("ckpt_write@1=truncate")
        try:
            _save(pkg, path, 2.0, 1)
        finally:
            pkg.schedule("")
        weight, info, msgs = _load(pkg, path)
        assert msgs, f"{name}: expected a skip warning"
        out[name] = (weight.tolist(), info["version"], info["committed"],
                     [os.path.basename(s) for s in info["skipped"]])
    assert out["port"] == out["jax"]
    assert out["port"][1] == "0"


def test_async_failure_raises_at_the_join_and_before_a_load(tmp_path,
                                                           monkeypatch):
    for name, pkg in PACKAGES.items():
        path = str(tmp_path / name / "ck")
        pkg.fail_next_async(path, 7, monkeypatch)
        with pytest.raises(pkg.ck.AsyncSaveError,
                           match="background save died"):
            pkg.ck.wait_async_save()
        assert not os.path.exists(os.path.join(path, "7",
                                               pkg.ck.COMMIT_FILE))
        pkg.fail_next_async(path, 7, monkeypatch)
        with pytest.raises(pkg.ck.AsyncSaveError):
            pkg.ck.load_state_dict(pkg.linear().state_dict(), path)
        assert not pkg.ck._ASYNC_SAVES
        monkeypatch.undo()


def test_async_save_commits_at_the_join(tmp_path):
    def run(pkg, path):
        pkg.ck.save_state_dict(pkg.linear(4.0).state_dict(), path,
                               unique_id=0, async_save=True,
                               metadata={"step": 0})
        pkg.ck.wait_async_save()
        committed = os.path.exists(os.path.join(path, "0",
                                                pkg.ck.COMMIT_FILE))
        got = pkg.ck.latest_committed(path)
        return committed, got[1]["meta"], _summary(*_load(pkg, path))
    committed, meta, got = _both(tmp_path, run)
    assert committed and meta == {"step": 0}
    assert got["weight"] == [[4.0] * 3] * 3


def test_keep_last_k_retention(tmp_path):
    def run(pkg, path):
        for s in range(6):
            _save(pkg, path, float(s), s, keep_last_k=3)
        return sorted(os.listdir(path)), _summary(*_load(pkg, path))
    dirs, got = _both(tmp_path, run)
    assert dirs == ["3", "4", "5"]
    assert got["version"] == "5" and got["weight"] == [[5.0] * 3] * 3


def test_version_tiebreak_is_deterministic(tmp_path):
    def run(pkg, path):
        for name in ("run_a", "run_b"):
            d = os.path.join(path, name)
            os.makedirs(d)
            with open(os.path.join(d, pkg.ck.COMMIT_FILE), "w") as f:
                json.dump({"v": 1, "t": 0.0, "arrays": {},
                           "meta": {"name": name}}, f)
        t = time.time()
        for name in ("run_a", "run_b"):
            os.utime(os.path.join(path, name), (t, t))
        return [pkg.ck.latest_committed(path)[1]["meta"]["name"]
                for _ in range(3)]
    assert _both(tmp_path, run) == ["run_b"] * 3


def test_group_and_coordinator_checks(tmp_path):
    for name, pkg in PACKAGES.items():
        sd = pkg.linear(1.0).state_dict()
        with pytest.raises(ValueError):
            pkg.ck.save_state_dict(sd, str(tmp_path / name),
                                   process_group=object())
        with pytest.raises(ValueError):
            pkg.ck.save_state_dict(sd, str(tmp_path / name),
                                   coordinator_rank=1)


def test_legacy_version_without_commit_loads_with_a_warning(tmp_path):
    path = str(tmp_path / "ck")
    _save(_Port, path, 6.0, 0)
    os.remove(os.path.join(path, "0", pck.COMMIT_FILE))
    weight, info, msgs = _load(_Port, path)
    assert weight.tolist() == [[6.0] * 3] * 3
    assert info["version"] == "0" and not info["committed"]
    assert any("falling back" in m for m in msgs)
    m = _Port.linear()
    with pytest.warns(UserWarning, match="no _COMMIT"):
        pck.load_state_dict(m.state_dict(), path, unique_id=0)


def test_async_snapshot_is_taken_before_return(tmp_path):
    path = str(tmp_path / "ck")
    m = _Port.linear(1.0)
    pck.save_state_dict(m.state_dict(), path, unique_id=0, async_save=True)
    with torch.no_grad():
        m.weight.fill_(5.0)                    # after the call returned
    pck.wait_async_save()
    weight, info, _ = _load(_Port, path)
    assert weight.tolist() == [[1.0] * 3] * 3 and info["committed"]


def test_offload_loads_cpu_copies(tmp_path):
    path = str(tmp_path / "ck")
    _save(_Port, path, 2.5, 0)
    m = _Port.linear(0.0)
    sd = m.state_dict()
    pck.load_state_dict(sd, path, offload=True)
    assert sd["weight"].device.type == "cpu"
    assert sd["weight"].tolist() == [[2.5] * 3] * 3
    assert m.weight.detach().tolist() == [[0.0] * 3] * 3


def test_optimizer_state_by_parameter_name(tmp_path):
    """A plain AdamW's accumulators are saved by the parameter's name and
    load into another optimizer over a model built in another order;
    the torch-format ``state_dict`` and ``set_state_dict`` are as
    before."""
    from paddle_tpu_torch.optimizer import AdamW
    torch.manual_seed(0)
    m = torch.nn.Sequential(torch.nn.Linear(4, 4), torch.nn.Linear(4, 2))
    opt = AdamW(learning_rate=1e-2, parameters=m.parameters())
    for _ in range(2):
        m(torch.randn(3, 4)).square().mean().backward()
        opt.step()
        opt.clear_grad()
    assert set(opt.state_dict()["state"]) == {0, 1, 2, 3}
    path = str(tmp_path / "ck")
    pck.save_state_dict({"model": m.state_dict(),
                         "opt": opt.state_dict()}, path)
    meta = json.load(open(os.path.join(path, "0.metadata")))
    keys = {p["key"] for p in meta["pieces"]}
    assert "opt.0.weight_moment1" in keys and "opt.1.bias_beta2_pow" in keys
    assert meta["values"]["opt.global_step"] == 2

    m2 = torch.nn.Sequential(torch.nn.Linear(4, 4), torch.nn.Linear(4, 2))
    params = list(m2.parameters())[::-1]       # another parameter order
    opt2 = AdamW(learning_rate=1e-2, parameters=params)
    pck.load_state_dict({"model": m2.state_dict(),
                         "opt": opt2.state_dict()}, path)
    for (n, p), q in zip(m.named_parameters(), m2.parameters()):
        assert torch.equal(p, q), n
        for k in ("moment1", "moment2", "beta_pows"):
            assert torch.equal(opt.state[p][k], opt2.state[q][k]), (n, k)
    assert opt2._global_step == 2
    opt3 = AdamW(learning_rate=1e-2, parameters=m.parameters())
    opt3.set_state_dict(opt.state_dict())
    assert torch.equal(opt3.state[m[0].weight]["moment2"],
                       opt.state[m[0].weight]["moment2"])


def _np_piece(full, key, axis, boxes, lo=0, hi=None):
    """A piece holding ``full``'s boxes (concatenated along ``axis``),
    its flat range ``[lo, hi)``."""
    local = np.concatenate([full[tuple(slice(o, o + n) for o, n in
                                       zip(off, ln))] for off, ln in boxes],
                           axis=axis)
    data = torch.from_numpy(local.reshape(-1)[lo:hi].copy())
    return pc.piece(key, data, local.shape, full.shape, axis, boxes, lo,
                    hi if hi is not None else local.size)


def _qkv_boxes(rows, h, n, r):
    """Rank r of n's boxes of a packed [rows, 3h] qkv (``shard_of``'s
    cut: each third split over the ranks)."""
    w = h // n
    return [((0, j * h + r * w), (rows, w)) for j in range(3)]


@pytest.mark.parametrize("src_n,dst_n", [(4, 2), (2, 3), (4, 1), (1, 4),
                                         (3, 4)])
def test_overlaps_packed_qkv_and_zero_ranges(src_n, dst_n):
    """Saved pieces of one layout fill the pieces of another exactly: a
    packed qkv [5, 36] in ``src_n`` mp shards (three boxes each), each
    shard cut into two ZeRO ranges at a point inside a row, loaded as
    ``dst_n`` mp shards whole and as a range cut at both ends."""
    rows, h = 5, 12
    full = np.arange(rows * 3 * h, dtype=np.float32).reshape(rows, 3 * h)
    src = []
    for r in range(src_n):
        boxes = _qkv_boxes(rows, h, src_n, r)
        size = full.size // src_n
        cut = size // 2 + 1                     # through a row
        src += [_np_piece(full, "w", 1, boxes, 0, cut),
                _np_piece(full, "w", 1, boxes, cut, size)]
    for r in range(dst_n):
        want = _np_piece(full, "w", 1, _qkv_boxes(rows, h, dst_n, r))
        size = want.numel
        for lo, hi in ((0, size), (1, size - 2)):
            dst = pc.piece("w", torch.zeros(hi - lo), want.lshape,
                           full.shape, 1, want.boxes, lo, hi)
            covered = 0
            for sp in src:
                for dc, sc, dreg, sreg in pc.overlaps(pc.chunks(dst),
                                                      pc.chunks(sp)):
                    v = pc.block_view(sp.data, sc)[sreg]
                    pc.block_view(dst.data, dc)[dreg].copy_(v)
                    covered += v.numel()
            assert covered == hi - lo
            assert torch.equal(dst.data, want.data[lo:hi])


def test_chunks_of_a_scalar_and_a_3d_range():
    s = pc.whole("s", torch.tensor(3.0))
    assert pc.chunks(s) == [((), (), 0, (), ())]
    full = np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4)
    p = _np_piece(full, "t", 0, [((0, 0, 0), (2, 3, 4))], 5, 19)
    got = np.zeros_like(full).reshape(-1)
    for goff, glen, start, bshape, bsl in pc.chunks(p):
        block = p.data[start:start + int(np.prod(bshape))].view(bshape)[bsl]
        idx = tuple(slice(o, o + n) for o, n in zip(goff, glen))
        view = got.reshape(full.shape)
        view[idx] = block.numpy()
    assert np.array_equal(got[5:19], full.reshape(-1)[5:19])
    assert not got[:5].any() and not got[19:].any()
