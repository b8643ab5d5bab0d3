"""The port's semi-auto API and ``Engine`` against ``paddle_tpu``'s, in
one process (a world of one; ``test_torch_auto_parallel_dist.py`` runs
four gloo ranks).

* ``ProcessMesh`` and the placements: the JAX package's properties,
  ``__eq__`` / ``__hash__`` / ``repr``; a rank beyond the world raises.
* ``shard_tensor`` / ``reshard`` / ``unshard_dtensor`` at one rank: the
  dist attr and the global shape recorded, a parameter kept in place.
* ``Strategy``: the JAX package's configs and defaults, dict merging.
* ``Engine.fit`` on ``tests/test_auto_parallel.py::test_engine_fit``'s
  data (weights carried from the JAX ``Linear``) against the JAX
  ``Engine``'s losses (fp32, ``rtol 1e-5``), and through ``to_static``.
* ``cost()``: ``None`` before a step; a bias-free ``Linear`` stack's
  FLOPs are 6 x rows x parameters less the first layer's input
  gradient (2 x rows x its parameters: the batch needs none).
* ``save`` / ``load``: the files hold the JAX ``Engine``'s keys and
  values; the port loads the JAX package's files and trains on as the
  JAX ``Engine`` does.
* ``tune``'s policy at one rank, with ``_card_backend`` monkeypatched:
  an explicit candidate list is never truncated (candidates that do not
  factor the world record their error), and a warm plan cache resolves
  with zero trial steps.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu.distributed import auto_parallel as jap
from paddle_tpu.distributed.communication.group import _reset_groups
from paddle_tpu.distributed.fleet.base.topology import _clear_hcg
from paddle_tpu.distributed.mesh import reset_mesh

import paddle_tpu_torch.distributed as tdist
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed import auto_parallel as tap
from paddle_tpu_torch.distributed.auto_parallel import engine as teng
from paddle_tpu_torch.distributed.mesh import reset_mesh as t_reset_mesh
from paddle_tpu_torch.nn import GELU, Linear
from paddle_tpu_torch.tuning import cache as tcache_mod

LOSS_RTOL = 1e-5


def _fresh():
    reset_mesh()
    _reset_groups()
    _clear_hcg()
    t_reset_mesh()


@pytest.fixture(autouse=True)
def _cleanup():
    _fresh()
    yield
    _fresh()


def _mse(out, y):
    return ((out - y) ** 2).mean()


def _carry(jax_model, port_model):
    """The JAX model's parameters into the port's, by name."""
    want = {n: np.asarray(p._data) for n, p in jax_model.named_parameters()}
    with torch.no_grad():
        for n, p in port_model.named_parameters():
            p.copy_(torch.from_numpy(np.array(want[n])))


def test_process_mesh_basics_and_world_bound():
    m = tap.ProcessMesh([[0]], dim_names=["dp", "mp"])
    assert m.shape == [1, 1] and m.ndim == 2 and m.process_ids == [0]
    assert m.dim_names == ["dp", "mp"] and m.get_dim_size("mp") == 1
    assert m.rank_mesh.axis_names == ("dp", "mp")
    assert m.get_mesh_with_dim("mp").dim_names == ["mp", "dp"]
    assert m == tap.ProcessMesh([[0]], dim_names=["dp", "mp"])
    assert m != tap.ProcessMesh([[0]], dim_names=["x", "y"])
    assert tap.ProcessMesh([0]).dim_names == \
        jap.ProcessMesh([0]).dim_names == ["d0"]
    j = jap.ProcessMesh([[0, 1, 2, 3], [4, 5, 6, 7]], dim_names=["x", "y"])
    with pytest.raises(ValueError, match="world has only 1"):
        tap.ProcessMesh([[0, 1, 2, 3], [4, 5, 6, 7]], dim_names=["x", "y"])
    assert repr(tap.ProcessMesh([[0]], ["x", "y"])).startswith(
        repr(j).split("shape")[0])


def test_placements_match_jax():
    for cls in ("Shard", "Replicate", "Partial"):
        assert hasattr(tap, cls) and hasattr(tdist, cls)
    for jp, tp in ((jap.Shard(1), tap.Shard(1)), (jap.Replicate(),
                                                  tap.Replicate()),
                   (jap.Partial(), tap.Partial())):
        assert repr(jp) == repr(tp)
        assert (jp.is_shard(), jp.is_replicate(), jp.is_partial()) == \
            (tp.is_shard(), tp.is_replicate(), tp.is_partial())
    assert tap.Shard(1) == tap.Shard(1) and tap.Shard(0) != tap.Shard(1)
    assert hash(tap.Shard(2)) == hash(tap.Shard(2))
    assert len({tap.Replicate(), tap.Replicate(), tap.Shard(0)}) == 2
    assert tap.Shard(1).get_dim() == 1 and tap.Shard(1).is_shard(1)
    assert not tap.Shard(1).is_shard(0)
    da = tap.DistAttr(tap.ProcessMesh([0]), [tap.Shard(0)])
    assert da.placements == [tap.Shard(0)] and da.global_shape is None


def test_shard_tensor_records_the_dist_attr_at_one_rank():
    mesh = tap.ProcessMesh([0], dim_names=["x"])
    t = torch.arange(32, dtype=torch.float32).reshape(8, 4)
    out = tap.shard_tensor(t, mesh, [tap.Shard(0)])
    assert out is t and tap.get_dist_attr(t).placements == [tap.Shard(0)]
    assert tap.global_shape(t) == [8, 4] and list(t.shape) == [8, 4]
    assert torch.equal(tap.unshard_dtensor(t), torch.arange(32.).reshape(8, 4))
    r = tap.reshard(t, mesh, [tap.Replicate()])
    assert r is not t and tap.get_dist_attr(r).placements == [
        tap.Replicate()]
    p = tap.shard_tensor(np.ones((2, 3), np.float32), mesh, [tap.Partial()],
                         place="cpu", stop_gradient=False)
    assert p.requires_grad and torch.equal(tap.unshard_dtensor(p).detach(),
                                           torch.ones(2, 3))
    d = tap.dtensor_from_fn(torch.zeros, mesh, [tap.Replicate()], [16, 4])
    assert tap.global_shape(d) == [16, 4]
    lin = Linear(4, 4, device="cpu")
    w = lin.weight
    tap.shard_layer(lin, mesh)
    assert lin.weight is w and tap.get_dist_attr(lin.weight) is not None
    assert tap.get_dist_attr(torch.zeros(1)) is None
    with pytest.raises(NotImplementedError, match="over other ranks"):
        _other_ranks(t)
    with pytest.raises(NotImplementedError, match="pending sum"):
        tap.shard_tensor(torch.ones(2), mesh, [tap.Partial("max")])


def _other_ranks(t):
    """A reshard to a mesh over other ranks (a mesh object naming rank
    1, built past the world check)."""
    other = object.__new__(tap.ProcessMesh)
    other._ranks = np.array([1])
    other._dim_names = ["x"]
    return tap.reshard(t, other, [tap.Replicate()])


def test_placements_outside_the_rule_table_raise():
    from paddle_tpu_torch.jit import train_step
    dp = tap.ProcessMesh([0], dim_names=["dp"])
    mp = tap.ProcessMesh([[0]], dim_names=["dp", "mp"])
    cases = []
    m = torch.nn.Sequential(Linear(4, 8, device="cpu"))
    tap.shard_tensor(m[0].weight, dp, [tap.Shard(1)])
    cases.append((m, "0.weight.*Shard\\(dim=1\\).*'dp'"))
    m = torch.nn.Sequential(Linear(4, 8, device="cpu"))
    tap.shard_tensor(m[0].weight, mp, [tap.Replicate(), tap.Partial()])
    cases.append((m, "0.weight.*Partial"))
    m = torch.nn.Sequential(Linear(4, 8, device="cpu"))
    tap.shard_tensor(m[0].bias, mp, [tap.Replicate(), tap.Shard(0)])
    cases.append((m, "rule table"))
    m = torch.nn.Sequential(torch.nn.LayerNorm(8))
    tap.shard_tensor(m[0].weight, mp, [tap.Replicate(), tap.Shard(0)])
    cases.append((m, "0.weight of a LayerNorm"))
    for model, match in cases:
        with pytest.raises(NotImplementedError, match=match):
            train_step(model, _mse, topt.SGD(parameters=model.parameters()))
    ok = torch.nn.Sequential(Linear(4, 8, device="cpu"), GELU(),
                             Linear(8, 4, device="cpu"))
    tap.shard_tensor(ok[0].weight, mp, [tap.Replicate(), tap.Shard(1)])
    tap.shard_tensor(ok[0].bias, mp, [tap.Replicate(), tap.Shard(0)])
    tap.shard_tensor(ok[2].weight, mp, [tap.Replicate(), tap.Shard(0)])
    tap.api.check_placements(ok)


def test_strategy_matches_jax_and_merges_dicts():
    from paddle_tpu.distributed.auto_parallel.strategy import (
        Strategy as JStrategy)
    j, t = JStrategy(), tap.Strategy()
    assert set(vars(j)) == set(vars(t))
    for k, v in vars(j).items():
        tv = getattr(t, k)
        if hasattr(v, "__dict__"):
            assert type(v).__name__ == type(tv).__name__
            assert vars(v) == vars(tv), k
        else:
            assert v == tv, k
    s = tap.Strategy({"tuning": {"enable": True, "profile": True},
                      "seed": 4})
    assert isinstance(s.tuning, tap.strategy.TuningConfig)
    assert s.tuning.enable and s.tuning.profile
    assert s.tuning.candidates is None and s.seed == 4


class _FitData:
    """``tests/test_auto_parallel.py::test_engine_fit``'s dataset."""

    def __init__(self, base):
        rs = np.random.RandomState(1)
        x = rs.randn(64, 8).astype("float32")
        y = rs.randn(64, 2).astype("float32")

        class DS(base):
            def __len__(self):
                return 64

            def __getitem__(self, i):
                return x[i], y[i]
        self.ds = DS()


def _jax_fit():
    from paddle_tpu.io import Dataset
    jap.set_mesh(jap.ProcessMesh(list(range(8)), dim_names=["dp"]))
    paddle.seed(3)
    model = jnn.Linear(8, 2)
    w = {n: np.asarray(p._data) for n, p in model.named_parameters()}
    o = jopt.SGD(learning_rate=0.1, parameters=model.parameters())
    eng = jap.Engine(model, loss=_mse, optimizer=o, strategy=jap.Strategy())
    hist = eng.fit(_FitData(Dataset).ds, batch_size=16, epochs=2)
    return w, hist["loss"]


def _port_linear(w):
    m = Linear(8, 2, device="cpu")
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(np.array(w["weight"])))
        m.bias.copy_(torch.from_numpy(np.array(w["bias"])))
    return m


def test_engine_fit_matches_jax():
    from paddle_tpu_torch.io import Dataset
    w, want = _jax_fit()
    _fresh()
    tap.set_mesh(tap.ProcessMesh([0], dim_names=["dp"]))
    m = _port_linear(w)
    eng = tap.Engine(m, loss=_mse, optimizer=topt.SGD(
        learning_rate=0.1, parameters=m.parameters()),
        strategy=tap.Strategy())
    hist = eng.fit(_FitData(Dataset).ds, batch_size=16, epochs=2)
    assert len(hist["loss"]) == 8 and hist["loss"][-1] < hist["loss"][0]
    np.testing.assert_allclose(hist["loss"], want, rtol=LOSS_RTOL)
    assert len(eng.data_seconds) == len(eng.step_seconds) == 8
    # to_static's DistModel takes the same steps
    _fresh()
    m2 = _port_linear(w)
    dm = tdist.to_static(m2, None, _mse, topt.SGD(
        learning_rate=0.1, parameters=m2.parameters()))
    from paddle_tpu_torch.io import DataLoader
    got = [float(dm(x, y)) for _ in range(2)
           for x, y in DataLoader(_FitData(Dataset).ds, batch_size=16)]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    dm.eval()
    x, y = next(iter(DataLoader(_FitData(Dataset).ds, batch_size=16)))
    with torch.no_grad():
        want_eval = float(_mse(m2(x), y))
    assert float(dm(x, y)) == pytest.approx(want_eval)


def test_engine_cost_counts_a_linear_stack():
    rows, dims = 12, (16, 32, 8)
    m = torch.nn.Sequential(
        Linear(dims[0], dims[1], bias_attr=False, device="cpu"), GELU(),
        Linear(dims[1], dims[2], bias_attr=False, device="cpu"))
    o = topt.AdamW(learning_rate=1e-3, parameters=m.parameters())
    eng = tap.Engine(m, loss=_mse, optimizer=o)
    assert eng.cost() is None

    class DS:
        def __len__(self):
            return 2

        def __getitem__(self, i):
            rs = np.random.RandomState(i)
            return (rs.randn(rows, dims[0]).astype("float32"),
                    rs.randn(rows, dims[2]).astype("float32"))
    eng.fit(DS(), batch_size=None, epochs=1)
    time_ms, mem_bytes = eng.cost()
    n_params = sum(p.numel() for p in m.parameters())
    first = dims[0] * dims[1]
    flops = 6 * rows * n_params - 2 * rows * first
    assert eng._cost[0] == flops
    assert time_ms == pytest.approx(flops / (0.5 * 989e12) * 1e3)
    # parameters, gradients, and AdamW's two moments and powers
    assert mem_bytes == 4 * 4 * n_params + 2 * 2 * 4
    # the cost is the first step's: later steps leave it
    eng.fit(DS(), batch_size=None, epochs=1)
    assert eng.cost() == (time_ms, mem_bytes)


def _stack_jax(seed):
    paddle.seed(seed)
    m = jnn.Sequential(jnn.Linear(16, 32), jnn.GELU(), jnn.Linear(32, 4))
    o = jopt.AdamW(learning_rate=1e-3, parameters=m.parameters())
    return m, o


def _stack_port():
    m = torch.nn.Sequential(Linear(16, 32, device="cpu"), GELU(),
                            Linear(32, 4, device="cpu"))
    return m, topt.AdamW(learning_rate=1e-3, parameters=m.parameters())


class _Batches:
    def __len__(self):
        return 3

    def __getitem__(self, i):
        rs = np.random.RandomState(10 + i)
        return (rs.randn(8, 16).astype("float32"),
                rs.randn(8, 4).astype("float32"))


def test_save_writes_the_jax_engines_files(tmp_path):
    from paddle_tpu_torch import load
    jm, jo = _stack_jax(7)
    je = jap.Engine(jm, loss=_mse, optimizer=jo)
    tm, to = _stack_port()
    _carry(jm, tm)
    te = tap.Engine(tm, loss=_mse, optimizer=to)
    want = je.fit(_Batches(), batch_size=None)["loss"]
    got = te.fit(_Batches(), batch_size=None)["loss"]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    je.save(str(tmp_path / "jax"))
    te.save(str(tmp_path / "port"))
    for ext in (".pdparams", ".pdopt"):
        j = load(str(tmp_path / "jax") + ext, return_numpy=True)
        t = load(str(tmp_path / "port") + ext, return_numpy=True)
        assert list(j) == list(t), ext
        # the JAX jitted step's counter stops at 2; the port counts
        # every step
        if ext == ".pdopt":
            assert (j["global_step"], t["global_step"]) == (2, 3)
        for k in j:
            if k == "global_step":
                continue
            if isinstance(j[k], dict):
                assert list(j[k]) == list(t[k])
                continue
            a, b = np.asarray(j[k]), np.asarray(t[k])
            assert a.shape == b.shape, k
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-7,
                                       err_msg=k)


def test_load_reads_jax_files_and_trains_on(tmp_path):
    jm, jo = _stack_jax(8)
    je = jap.Engine(jm, loss=_mse, optimizer=jo)
    je.fit(_Batches(), batch_size=None)
    je.save(str(tmp_path / "jax"))
    tm, to = _stack_port()
    te = tap.Engine(tm, loss=_mse, optimizer=to)
    te.load(str(tmp_path / "jax"))
    for n, p in tm.named_parameters():
        np.testing.assert_array_equal(
            p.detach().numpy(), np.asarray(dict(jm.named_parameters())[n]
                                           ._data))
    assert to._global_step == jo._global_step
    want = je.fit(_Batches(), batch_size=None)["loss"]
    got = te.fit(_Batches(), batch_size=None)["loss"]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    # the port's own files resume bit for bit
    te.save(str(tmp_path / "port"))
    tm2, to2 = _stack_port()
    te2 = tap.Engine(tm2, loss=_mse, optimizer=to2)
    te2.load(str(tmp_path / "port"))
    assert te2.fit(_Batches(), batch_size=None)["loss"] == \
        te.fit(_Batches(), batch_size=None)["loss"]
    for a, b in zip(tm.parameters(), tm2.parameters()):
        assert torch.equal(a, b)


def _tune_engine():
    torch.manual_seed(0)
    m = torch.nn.Sequential(Linear(16, 32, device="cpu"),
                            torch.nn.ReLU(), Linear(32, 8, device="cpu"))
    o = topt.SGD(learning_rate=0.1, parameters=m.parameters())
    return m, tap.Engine(m, loss=_mse, optimizer=o,
                         strategy=tap.Strategy())


def _xy():
    rs = np.random.RandomState(0)
    return (rs.randn(8, 16).astype(np.float32),
            rs.randn(8, 8).astype(np.float32))


def test_tune_never_truncates_an_explicit_list(monkeypatch):
    monkeypatch.setattr(teng, "_card_backend", lambda: True)
    m, eng = _tune_engine()
    before = [p.detach().clone() for p in m.parameters()]
    x, y = _xy()
    cands = [(1, 1, 1), (2, 1, 1), (1, 2, 1), (1, 1, 2)]
    got = eng.tune(x, y, candidates=cands)
    assert (got["dp"], got["sharding"], got["mp"]) == (1, 1, 1)
    rep = eng.tuning_report
    assert not [e for e in rep if e.get("skipped", "").startswith("below")]
    assert len([e for e in rep if "step_s" in e or "error" in e]) == 4
    errs = [e for e in rep if "error" in e]
    assert len(errs) == 3 and all("multiply to 2" in e["error"]
                                  for e in errs)
    for a, b in zip(before, m.parameters()):
        assert torch.equal(a, b)
    hist = eng.fit(_TensorBatches(x, y), batch_size=8)
    assert np.isfinite(hist["loss"]).all()
    eng2 = _tune_engine()[1]
    eng2.tune(x, y, candidates=cands, top_k=1)
    assert len([e for e in eng2.tuning_report
                if e.get("skipped", "").startswith("below")]) == 3


def _TensorBatches(x, y):
    from paddle_tpu_torch.io import TensorDataset
    return TensorDataset([torch.from_numpy(x), torch.from_numpy(y)])


def test_tune_warm_cache_takes_no_trial_step(tmp_path, monkeypatch):
    from paddle_tpu_torch.flags import set_flags
    import sys
    ts_mod = sys.modules["paddle_tpu_torch.jit.train_step"]
    set_flags({"FLAGS_tuning_cache_dir": str(tmp_path)})
    tcache_mod._active = None
    try:
        m, eng = _tune_engine()
        x, y = _xy()
        cands = [(1, 1, 1), (1, 1, 2)]
        got = eng.tune(x, y, candidates=cands)
        st = tcache_mod.get_cache().stats()["engine_plan"]
        assert st["stores"] == 1 and st["misses"] == 1
        assert "cached" not in got
        tcache_mod._active = None

        def poisoned(*a, **kw):
            raise AssertionError("trial step built despite a warm cache")
        monkeypatch.setattr(ts_mod, "TrainStep", poisoned)
        eng2 = _tune_engine()[1]
        got2 = eng2.tune(x, y, candidates=cands)
        monkeypatch.undo()
        assert got2["cached"] is True and got2["dp"] == got["dp"]
        assert tcache_mod.get_cache().stats()["engine_plan"]["hits"] == 1
        assert eng2.tuning_report[-1]["cache"] == "hit"
        rec = next(iter(tcache_mod.get_cache().entries("engine_plan")))
        assert rec["value"]["layout"]["mesh_axes"] == {
            "dp": 1, "sharding": 1, "mp": 1}
        hist = eng2.fit(_TensorBatches(x, y), batch_size=8)
        assert np.isfinite(hist["loss"]).all()
    finally:
        set_flags({"FLAGS_tuning_cache_dir": ""})
        tcache_mod._active = None


def test_semi_auto_names_are_reexported():
    import paddle_tpu.distributed as jd
    for name in ("shard_tensor", "shard_layer", "shard_optimizer", "reshard",
                 "ProcessMesh", "Shard", "Replicate", "Partial",
                 "dtensor_from_fn", "shard_dataloader", "to_static",
                 "Strategy", "DistAttr", "unshard_dtensor"):
        assert getattr(jd, name).__name__ == getattr(tdist, name).__name__
        assert getattr(tdist, name) is getattr(tap, name)
    loader = object.__new__(__import__("paddle_tpu_torch.io").io.DataLoader)
    assert tdist.shard_dataloader(loader, [None]) is loader
    o = topt.SGD(parameters=[torch.nn.Parameter(torch.zeros(1))])
    assert tdist.shard_optimizer(o) is o and o._auto_parallel_sharded


def _plan_head(cands):
    """A learned model with a ``plan`` head (the JAX package's fixture
    samples, ``tests/test_learned_perf.py``)."""
    from paddle_tpu_torch.tuning.learned import (LearnedPerfModel, _Head,
                                                 plan_feature_dict)
    samples = []
    for bt in (128, 1024, 8192):
        for c in cands:
            f = plan_feature_dict(c, bt, 1 << 20)
            samples.append((f, 1e-9 * f["analytic_s"] * 2.0))
    return LearnedPerfModel({"plan": _Head.fit("plan", samples)})


@pytest.mark.parametrize("flag", [True, False])
def test_tune_takes_the_plan_heads_winner(tmp_path, monkeypatch, flag):
    """On a plan-cache miss with a trained plan head (and
    ``FLAGS_learned_perf_model``), tune() installs the predicted winner
    without a trial step and stores it; with the flag off it measures
    and stores the workload's scale for the head's training."""
    import sys
    from paddle_tpu_torch.distributed.mesh import get_mesh
    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.tuning import learned
    ts_mod = sys.modules["paddle_tpu_torch.jit.train_step"]
    model = _plan_head([(8, 1, 1), (4, 2, 1), (2, 2, 2), (1, 1, 8),
                        (1, 1, 1)])
    learned.save_model(model, str(tmp_path))
    set_flags({"FLAGS_tuning_cache_dir": str(tmp_path),
               "FLAGS_learned_perf_model": flag})
    tcache_mod._active = None
    try:
        m, eng = _tune_engine()
        x, y = _xy()
        if flag:
            def poisoned(*a, **kw):
                raise AssertionError("trial step built despite a plan head")
            monkeypatch.setattr(ts_mod, "TrainStep", poisoned)
        got = eng.tune(x, y, candidates=[(1, 1, 1)])
        monkeypatch.undo()
        entry = next(tcache_mod.get_cache().entries("engine_plan"))["value"]
        if flag:
            assert got["predicted"] is True
            (row,) = got["report"]
            assert row["source"] == "learned"
            assert row["predicted_s"] == round(model.plan_seconds(
                (1, 1, 1), x.size, eng._param_bytes()), 6)
            assert entry["source"] == "learned"
        else:
            assert "predicted" not in got and "step_s" in got["report"][0]
            assert entry["batch_tokens"] == x.size
            assert entry["param_bytes"] == 4 * sum(
                p.numel() for p in m.parameters())
        assert get_mesh().shape == {"dp": 1, "pp": 1, "sharding": 1,
                                    "sep": 1, "cp": 1, "ep": 1, "mp": 1}
    finally:
        set_flags({"FLAGS_tuning_cache_dir": "",
                   "FLAGS_learned_perf_model": True})
        tcache_mod._active = None


@pytest.mark.parametrize("batch_tokens,param_bytes", [(128, 4000),
                                                      (4096, 10 ** 9),
                                                      (16, 10)])
def test_plan_ranking_and_layout_match_jax(batch_tokens, param_bytes):
    """``tune``'s roofline pre-rank and the plan cache's layout table are
    the JAX package's."""
    from paddle_tpu.tuning import cost_model as jcm
    from paddle_tpu_torch.tuning import cost_model as tcm
    cands = [(8, 1, 1), (4, 2, 1), (2, 2, 2), (1, 1, 8), (2, 1, 4),
             (1, 4, 2)]
    assert tcm.rank_plans(cands, batch_tokens, param_bytes) == \
        jcm.rank_plans(cands, batch_tokens, param_bytes)
    for c in cands:
        assert tcm.CostModel().plan_cost(c, batch_tokens, param_bytes) == \
            jcm.CostModel().plan_cost(c, batch_tokens, param_bytes)
        assert tcm.plan_layout(*c) == jcm.plan_layout(*c)
