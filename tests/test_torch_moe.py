"""The port's MoE layer, its gates, the global-norm clips and the MoE
dispatch helpers on the CPU, held against the JAX package.

* Routing: the port's ``route`` + ``dispatch_masks`` against the JAX
  ``MoELayer``'s ``moe_route`` op (its ``disp`` and ``comb``, read
  through a spy on the module's ``call_op``) on the same logits, given
  by a gate that returns them: ties everywhere (logits on a 0.5 grid:
  the lower expert wins, as ``jax.lax.top_k`` picks), capacity drops,
  k = 1, 2, 3.  Exact for ``disp``, ``comb`` within 1e-6.
* The index form (``MoELayer.forward``) against the one-hot einsum form
  (``forward_einsum``) in the port: fp32 outputs and gradients 1e-6,
  bf16 outputs 2e-2 (torch's bf16 einsum rounds its own way).
* Each gate's logits and aux loss against the JAX gate with its weights
  (1e-6 / 1e-5), and ``tests/test_moe_incubate.py``'s cases against the
  JAX ``MoELayer`` with carried weights: identity dispatch, capacity
  drops and 5 AdamW steps for each gate, on the stacked path and on the
  loop path (a ``Dropout`` in the experts while training), and the
  heterogeneous experts' warning and output.  Losses 1e-5, outputs 1e-5
  (fp32).
* ``ClipGradByGlobalNorm`` / ``ClipGradForMOEByGlobalNorm`` against the
  JAX clip (fp32 1e-6, bf16 exact: the same bf16 product);
  ``expert_count`` and ``global_scatter`` / ``global_gather`` at a world
  of one (the identity, and the JAX checks' ``ValueError``).
"""
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.distributed import utils as jutils
from paddle_tpu.incubate.distributed.models.moe import moe_layer as jml
from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JaxClip

from paddle_tpu_torch import amp, optimizer
from paddle_tpu_torch.distributed import utils as tutils
from paddle_tpu_torch.incubate.distributed.models.moe import (
    ClipGradForMOEByGlobalNorm, GShardGate, MoELayer, NaiveGate,
    SwitchGate)
from paddle_tpu_torch.incubate.distributed.models.moe.moe_layer import (
    dispatch_masks, route)
from paddle_tpu_torch.nn import GELU, ClipGradByGlobalNorm, Linear

ATOL = 1e-6
LOSS_ATOL = 1e-5


def _t(a, grad=False):
    return Tensor(np.asarray(a), stop_gradient=not grad)


def _np(t):
    return np.asarray(t._data)


class _FixedGate(jml.BaseGate):
    """A JAX gate that returns the logits it was given."""

    def __init__(self, logits, top_k):
        super().__init__(4, logits.shape[1], top_k=top_k)
        self.logits = logits

    def forward(self, x):
        return _t(self.logits), None


class _JaxDouble(jnn.Layer):
    def forward(self, x):
        return x * 2.0


def _jax_route(logits, k, cf, monkeypatch):
    """``disp`` and ``comb`` of the JAX layer's ``moe_route`` op."""
    seen = {}
    real = jml.call_op

    def spy(fn, args, kwargs=None, multi_out=False, op_name="", **kw):
        out = real(fn, args, kwargs, multi_out=multi_out, op_name=op_name,
                   **kw)
        if op_name == "moe_route":
            seen["disp"], seen["comb"] = (_np(o) for o in out)
        return out
    monkeypatch.setattr(jml, "call_op", spy)
    e = logits.shape[1]
    moe = jml.MoELayer(4, [_JaxDouble() for _ in range(e)],
                       gate=_FixedGate(logits, k), capacity_factor=cf)
    moe(_t(np.ones((logits.shape[0], 4), np.float32)))
    return seen["disp"], seen["comb"]


ROUTE_CASES = {
    # name: (T, E, k, capacity_factor, logits kind)
    "ties-top2-drops": (24, 4, 2, 0.5, "grid"),
    "ties-top1": (24, 4, 1, 1.0, "grid"),
    "ties-top3": (16, 6, 3, 0.75, "grid"),
    "normal-top2": (32, 8, 2, 1.25, "normal"),
    "ample-top2": (12, 4, 2, 4.0, "normal"),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_route_matches_jax(case, monkeypatch):
    t, e, k, cf, kind = ROUTE_CASES[case]
    rs = np.random.RandomState(len(case))
    logits = (rs.randint(0, 4, (t, e)) * 0.5 if kind == "grid"
              else rs.randn(t, e)).astype(np.float32)
    disp, comb = _jax_route(logits, k, cf, monkeypatch)
    cap = max(int(np.ceil(k * t / e * cf)), 1)
    plan = route(torch.tensor(logits), k, cap)
    got_disp, got_comb = dispatch_masks(*plan, e, cap)
    np.testing.assert_array_equal(got_disp.numpy(), disp)
    np.testing.assert_allclose(got_comb.numpy(), comb, rtol=0, atol=ATOL)
    if cf < 1:
        assert disp.sum() < t * k                # tokens were dropped


def _port_experts(n, d, g, dropout=False):
    mods = []
    for _ in range(n):
        layers = [Linear(d, 2 * d, generator=g, device="cpu"), GELU()]
        if dropout:
            layers.append(_Dropout())
        layers.append(Linear(2 * d, d, generator=g, device="cpu"))
        mods.append(torch.nn.Sequential(*layers))
    return mods


def _jax_experts(n, d, dropout=False):
    out = []
    for _ in range(n):
        layers = [jnn.Linear(d, 2 * d), jnn.GELU()]
        if dropout:
            layers.append(jnn.Dropout(0.0))
        layers.append(jnn.Linear(2 * d, d))
        out.append(jnn.Sequential(*layers))
    return out


class _Dropout(torch.nn.Module):
    """A dropout of rate 0: the identity that makes the experts
    stochastic (the loop path while training)."""

    def forward(self, x):
        return x


def _carry(port, jax_layer):
    sd = {k: torch.tensor(_np(v)) for k, v in jax_layer.state_dict().items()}
    port.load_state_dict(sd)


def _pair(gate_type, k, n, d, cf, seed, dropout=False):
    paddle.seed(seed)
    jmoe = jml.MoELayer(d, _jax_experts(n, d, dropout),
                        gate={"type": gate_type, "top_k": k},
                        capacity_factor=cf)
    g = torch.Generator().manual_seed(seed)
    pmoe = MoELayer(d, _port_experts(n, d, g, dropout),
                    gate={"type": gate_type, "top_k": k}, capacity_factor=cf,
                    generator=g, device="cpu")
    _carry(pmoe, jmoe)
    return jmoe, pmoe


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_index_form_matches_einsum_form(dtype):
    _, moe = _pair("gshard", 2, 4, 16, 0.75, 3)
    rs = np.random.RandomState(4)
    x = torch.tensor(rs.randn(6, 4, 16).astype(np.float32),
                     requires_grad=True)
    if dtype == "float32":
        y, y2 = moe(x), moe.forward_einsum(x)
        np.testing.assert_allclose(y.detach().numpy(), y2.detach().numpy(),
                                   rtol=0, atol=ATOL)
        gy = torch.tensor(rs.randn(6, 4, 16).astype(np.float32))
        g1 = torch.autograd.grad(y, [x] + list(moe.parameters()), gy)
        g2 = torch.autograd.grad(y2, [x] + list(moe.parameters()), gy)
        for a, b in zip(g1, g2):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=ATOL)
        return
    amp.decorate(models=moe, level="O2", dtype="bfloat16")
    with amp.auto_cast(enable=True, level="O2", dtype="bfloat16"):
        y, y2 = moe(x), moe.forward_einsum(x)
    assert y.dtype == torch.bfloat16 == y2.dtype
    np.testing.assert_allclose(y.float().detach().numpy(),
                               y2.float().detach().numpy(), rtol=0,
                               atol=2e-2)


@pytest.mark.parametrize("gate_type", ["naive", "gshard", "switch"])
def test_gate_matches_jax(gate_type):
    paddle.seed(2)
    jcls = jml.GATES[gate_type]
    jg = jcls(16, 8, top_k=1 if gate_type == "switch" else 2)
    jg.eval()
    pcls = {"naive": NaiveGate, "gshard": GShardGate,
            "switch": SwitchGate}[gate_type]
    pg = pcls(16, 8, top_k=1 if gate_type == "switch" else 2,
              device="cpu")
    pg.eval()
    _carry(pg, jg)
    x = np.random.RandomState(5).randn(20, 16).astype(np.float32)
    jl, jloss = jg(_t(x))
    pl, ploss = pg(torch.tensor(x))
    np.testing.assert_allclose(pl.detach().numpy(), _np(jl), rtol=0,
                               atol=ATOL)
    if gate_type == "naive":
        assert jloss is None and ploss is None
    else:
        np.testing.assert_allclose(float(ploss.detach()), float(jloss),
                                   rtol=1e-5)
        assert pg.get_loss() is ploss


def test_switch_gate_noise_in_training():
    """Training with ``switch_eps`` scales the logits by ``1 + eps *
    U(-1, 1)`` drawn from the gate's generator: reproducible from a seed,
    within eps of the clean logits."""
    x = torch.randn(20, 16)
    outs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(9)
        gate = SwitchGate(16, 8, generator=g, device="cpu")
        outs.append(gate(x)[0].detach())
        gate.eval()
        clean = gate(x)[0].detach()
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    assert (outs[0] - clean).abs().max() <= 0.1 * clean.abs().max() + 1e-6
    assert not torch.equal(outs[0], clean)


def test_moe_identity_dispatch():
    """Ample capacity and top-1 routing to a single expert reproduce
    ``expert(x)``, as the JAX layer does."""
    class Double(torch.nn.Module):
        def forward(self, x):
            return x * 2.0

    moe = MoELayer(8, [Double()], gate={"type": "naive", "top_k": 1},
                   capacity_factor=4.0, device="cpu")
    x = torch.tensor(np.random.RandomState(0).randn(4, 5, 8)
                     .astype(np.float32))
    np.testing.assert_allclose(moe(x).detach().numpy(), x.numpy() * 2.0,
                               rtol=1e-5)


def test_moe_capacity_drops_tokens():
    """capacity = ceil(8 / 1 * 0.25) = 2: exactly 2 tokens routed, as in
    the JAX layer, and the same ones."""
    class One(torch.nn.Module):
        def forward(self, x):
            return torch.ones_like(x)

    paddle.seed(2)

    class JOne(jnn.Layer):
        def forward(self, x):
            return paddle.ones_like(x)

    jmoe = jml.MoELayer(4, [JOne()], gate={"type": "naive", "top_k": 1},
                        capacity_factor=0.25)
    moe = MoELayer(4, [One()], gate={"type": "naive", "top_k": 1},
                   capacity_factor=0.25, device="cpu")
    _carry(moe, jmoe)
    x = np.random.RandomState(1).randn(8, 4).astype(np.float32)
    arr = moe(torch.tensor(x)).detach().numpy()
    assert (np.abs(arr).sum(-1) > 1e-6).sum() == 2
    np.testing.assert_allclose(arr, _np(jmoe(_t(x))), rtol=0, atol=ATOL)


TRAIN_CASES = [("gshard", 2, False), ("switch", 1, False),
               ("naive", 2, False), ("gshard", 2, True)]


@pytest.mark.parametrize("gate_type,k,loop", TRAIN_CASES)
def test_moe_trains_like_jax(gate_type, k, loop):
    """``test_moe_incubate.py``'s training case with carried weights: 5
    AdamW steps of MoE + head, the aux loss added at 0.01; ``loop``: a
    dropout in the experts puts training on the per-expert loop."""
    d = 16
    jmoe, pmoe = _pair(gate_type, k, 4, d, 2.0, 1, dropout=loop)
    assert pmoe._experts_stackable and pmoe._experts_stochastic == loop
    if gate_type == "switch":
        jmoe.eval()
        pmoe.eval()                          # no routing noise
    jhead, phead = jnn.Linear(d, 1), Linear(d, 1, device="cpu")
    _carry(phead, jhead)
    jo = jopt.AdamW(learning_rate=1e-3,
                    parameters=jmoe.parameters() + jhead.parameters())
    po = optimizer.AdamW(learning_rate=1e-3,
                         parameters=list(pmoe.parameters())
                         + list(phead.parameters()))
    rs = np.random.RandomState(0)
    x = rs.randn(16, 4, d).astype(np.float32)
    tgt = rs.randn(16, 4, 1).astype(np.float32)
    jl, pl = [], []
    for _ in range(5):
        loss = ((jhead(jmoe(_t(x))) - _t(tgt)) ** 2).mean()
        if jmoe.gate.get_loss() is not None:
            loss = loss + 0.01 * jmoe.gate.get_loss()
        loss.backward()
        jo.step()
        jo.clear_grad()
        jl.append(float(loss))
        loss = ((phead(pmoe(torch.tensor(x))) - torch.tensor(tgt)) ** 2
                ).mean()
        if pmoe.gate.get_loss() is not None:
            loss = loss + 0.01 * pmoe.gate.get_loss()
        loss.backward()
        po.step()
        po.clear_grad()
        pl.append(float(loss.detach()))
    np.testing.assert_allclose(pl, jl, rtol=0, atol=LOSS_ATOL)
    assert pl[-1] < pl[0]


def test_heterogeneous_experts_warn_and_match_jax():
    """Experts that cannot be stacked take the loop with the JAX layer's
    RuntimeWarning, and compute what it computes."""
    class JScale(jnn.Layer):
        def __init__(self, s):
            super().__init__()
            self.s = s
            self.lin = jnn.Linear(8, 8)

        def forward(self, x):
            return self.lin(x) * self.s

    class JOther(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.lin = jnn.Linear(8, 8)
            self.act = jnn.ReLU()

        def forward(self, x):
            return self.act(self.lin(x))

    class Scale(torch.nn.Module):
        def __init__(self, s):
            super().__init__()
            self.s = s
            self.lin = Linear(8, 8, device="cpu")

        def forward(self, x):
            return self.lin(x) * self.s

    class Other(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = Linear(8, 8, device="cpu")

        def forward(self, x):
            return torch.relu(self.lin(x))

    paddle.seed(3)
    jmoe = jml.MoELayer(8, [JScale(2.0), JOther()],
                        gate={"type": "naive", "top_k": 1})
    moe = MoELayer(8, [Scale(2.0), Other()],
                   gate={"type": "naive", "top_k": 1}, device="cpu")
    _carry(moe, jmoe)
    assert not moe._experts_stackable
    x = np.random.RandomState(2).randn(2, 4, 8).astype(np.float32)
    with pytest.warns(RuntimeWarning, match="heterogeneous"):
        out = moe(torch.tensor(x))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = _np(jmoe(_t(x)))
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("cls", ["global", "moe"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_norm_clip_matches_jax(cls, dtype):
    rs = np.random.RandomState(6)
    shapes = [(5, 7), (7,), (3, 2, 4)]
    grads = [rs.randn(*s).astype(np.float32) * 3 for s in shapes]
    tdt = getattr(torch, dtype)
    pgs = [(torch.zeros(s), torch.tensor(g).to(tdt))
           for s, g in zip(shapes, grads)]
    clip = ClipGradByGlobalNorm(1.5) if cls == "global" \
        else ClipGradForMOEByGlobalNorm(1.5)
    got = clip(pgs)
    import jax.numpy as jnp
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = JaxClip(1.5)([(None, Tensor(jnp.asarray(g).astype(jdt)))
                         for g in grads])
    for (_, a), (_, b) in zip(got, want):
        assert a.dtype == tdt
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b._data).astype(np.float32),
                                   rtol=0, atol=ATOL if dtype == "float32"
                                   else 0)


def test_optimizer_takes_global_norm_clips_only():
    p = torch.nn.Parameter(torch.ones(3))
    optimizer.AdamW(parameters=[p], grad_clip=ClipGradByGlobalNorm(1.0))
    optimizer.AdamW(parameters=[p],
                    grad_clip=ClipGradForMOEByGlobalNorm(1.0))
    with pytest.raises(NotImplementedError, match="grad_clip"):
        optimizer.AdamW(parameters=[p], grad_clip=object())


def test_expert_count_matches_jax():
    idx = np.random.RandomState(7).randint(0, 6, (5, 4))
    got = tutils.expert_count(torch.tensor(idx), 8)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(),
                                  _np(jutils.expert_count(_t(idx), 8)))


def test_global_scatter_gather_world_of_one():
    x = np.random.RandomState(8).randn(6, 3).astype(np.float32)
    lc, gc = np.array([2, 4]), np.array([1, 5])
    for t_fn, j_fn in ((tutils.global_scatter, jutils.global_scatter),
                       (tutils.global_gather, jutils.global_gather)):
        got = t_fn(torch.tensor(x), torch.tensor(lc), torch.tensor(gc))
        np.testing.assert_array_equal(got.numpy(),
                                      _np(j_fn(_t(x), _t(lc), _t(gc))))
    bad = np.array([1, 1])
    for t_fn, j_fn, args in (
            (tutils.global_scatter, jutils.global_scatter, (bad, gc)),
            (tutils.global_gather, jutils.global_gather, (lc, bad))):
        with pytest.raises(ValueError, match="sums to 2 but x has 6") as e:
            t_fn(torch.tensor(x), *map(torch.tensor, args))
        with pytest.raises(ValueError) as je:
            j_fn(_t(x), *map(_t, args))
        assert str(e.value) == str(je.value)
