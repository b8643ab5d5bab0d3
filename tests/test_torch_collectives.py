"""The port's collectives across 4 gloo ranks against the JAX package's
SPMD mode.

One 4-rank group (``tests/torch_dist_workers.py collectives``, started
by the port's launcher with ``--device cpu``) runs every check once and
writes each rank's results; the tests read them.  The JAX side runs the
same numpy inputs per rank through ``shard_map`` over a 4-device
``new_group`` mesh (and the same subgroups and mesh axes), as
``tests/test_collectives.py`` does: that is the counterpart of a
multi-process rank, not the JAX package's eager mode, where arrays are
global and a reduction is the identity.

Tolerances: fp32 ``rtol = atol = 2e-5`` for every op (sums of four
values in another order; PROD multiplies four values, AVG divides the
sum by 4, both within the same bound).  Point-to-point ops are held to
the reference's SPMD ``send``/``recv`` pairing, a ring shift by one
(rank r receives rank r-1's tensor).  The object ops, whose JAX
counterparts are single-controller stand-ins, are held to their
definitions.  ``all_reduce``'s gradient is the identity of the
reference's ``c_allreduce_sum_grad``; the sanitizer must raise on every
rank, before the launch, at the call that disagrees.
"""
import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu.distributed.communication.group import (_reset_groups,
                                                        axis_group)
from paddle_tpu.distributed.mesh import build_mesh, reset_mesh

import torch_dist_workers as workers
from torch_dist_workers import launch, wait_ranks

TOL = dict(rtol=2e-5, atol=2e-5)
N = workers.N_RANKS


def _fresh():
    reset_mesh()
    _reset_groups()


def _spmd(group, fn, *stacked):
    """``fn(*per_rank_tensors)`` on each rank of ``group`` (a JAX
    ``new_group``/``axis_group``) under ``shard_map``; ``stacked[i][r]``
    is rank r's input i; returns the stacked per-rank outputs."""
    mesh, axis = group._mesh, group.axis_name

    def per_rank(*xs):
        out = fn(*[paddle.Tensor(x[0]) for x in xs])
        return out.value[None]

    spec = P(axis)
    f = jax.shard_map(per_rank, mesh=mesh, in_specs=(spec,) * len(stacked),
                      out_specs=spec, check_vma=False)
    return np.asarray(jax.jit(f)(*stacked))


def _cat(ts):
    return paddle.concat(ts, axis=0)


def _jax_expected():
    """Every op's per-rank result in the JAX package's SPMD mode."""
    x, y = workers.collective_inputs()
    _fresh()
    g = jdist.new_group(list(range(N)))
    want = {}

    def reduced(op, group=g):
        def fn(t):
            jdist.all_reduce(t, op=op, group=group)
            return t
        return fn

    for name, op in (("sum", jdist.ReduceOp.SUM), ("max", jdist.ReduceOp.MAX),
                     ("min", jdist.ReduceOp.MIN), ("avg", jdist.ReduceOp.AVG),
                     ("prod", jdist.ReduceOp.PROD)):
        want[f"all_reduce_{name}"] = _spmd(g, reduced(op), x)
    want["all_reduce_async"] = want["all_reduce_sum"]

    def reduce_(t):
        jdist.reduce(t, dst=1, group=g)
        return t
    want["reduce"] = _spmd(g, reduce_, x)

    def gathered(t):
        lst = []
        jdist.all_gather(lst, t, group=g)
        return _cat(lst)
    want["all_gather"] = want["all_gather_async"] = _spmd(g, gathered, x)
    want["all_gather_functional"] = _spmd(
        g, lambda t: jdist.all_gather(None, t, group=g), x)

    def gather_(t):
        lst = []
        jdist.gather(t, lst, dst=0, group=g)
        return _cat(lst)
    want["gather"] = _spmd(g, gather_, x)

    def bcast(t):
        jdist.broadcast(t, src=2, group=g)
        return t
    want["broadcast"] = _spmd(g, bcast, x)

    def scatter_(chunks):
        t = paddle.zeros([2, 3])
        jdist.scatter(t, [chunks[j] for j in range(N)], src=1, group=g)
        return t
    want["scatter"] = _spmd(g, scatter_, y)
    for name, op in (("sum", jdist.ReduceOp.SUM), ("avg", jdist.ReduceOp.AVG),
                     ("max", jdist.ReduceOp.MAX)):
        want[f"reduce_scatter_{name}"] = _spmd(
            g, lambda t, op=op: jdist.reduce_scatter(t, op=op, group=g), x)

    def rs_list(chunks):
        t = paddle.zeros([2, 3])
        jdist.reduce_scatter(t, [chunks[j] for j in range(N)], group=g)
        return t
    want["reduce_scatter_list"] = _spmd(g, rs_list, y)

    def a2a(chunks):
        outs = []
        jdist.alltoall(outs, [chunks[j] for j in range(N)], group=g)
        return paddle.stack(outs)
    want["alltoall"] = _spmd(g, a2a, y)
    want["alltoall_single"] = _spmd(
        g, lambda t: jdist.alltoall_single(t, group=g), x)

    def ring(t):
        buf = paddle.zeros([8, 3])
        jdist.send(t, dst=1, group=g)
        jdist.recv(buf, src=0, group=g)
        return buf
    want["send_recv"] = _spmd(g, ring, x)

    def batch_ring(t):
        buf = paddle.zeros([8, 3])
        jdist.batch_isend_irecv([jdist.P2POp(jdist.isend, t, 1, g),
                                 jdist.P2POp(jdist.irecv, buf, 0, g)])
        return buf
    want["batch_isend_irecv"] = _spmd(g, batch_ring, x)

    pair = {}
    for ranks in ([0, 1], [2, 3]):
        sub = jdist.new_group(ranks)
        pair.update(zip(ranks, _spmd(
            sub, reduced(jdist.ReduceOp.SUM, sub), x[ranks])))
    want["new_group_sum"] = np.stack([pair[r] for r in range(N)])
    want["new_group_nonmember"] = x

    _fresh()
    mesh = build_mesh({"dp": 2, "mp": 2}, devices=jax.devices()[:N])
    for key, axes in (("mesh_mp_sum", "mp"), ("mesh_fused_sum",
                                               ("dp", "mp"))):
        ag = axis_group(axes, mesh)

        def fn(t, ag=ag):
            jdist.all_reduce(t, group=ag)
            return t
        f = jax.shard_map(lambda v: fn(paddle.Tensor(v[0])).value[None],
                          mesh=mesh, in_specs=P(("dp", "mp")),
                          out_specs=P(("dp", "mp")), check_vma=False)
        want[key] = np.asarray(jax.jit(f)(x))
    _fresh()
    return want


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("collectives")
    logs = out / "logs"
    proc = launch("collectives", out, logs)
    try:
        want = _jax_expected()          # while the ranks run
    except BaseException:
        proc.kill()
        proc.communicate()
        raise
    arrays, info = wait_ranks(proc, out, logs)
    return want, arrays, info


OPS = ["all_reduce_sum", "all_reduce_max", "all_reduce_min",
       "all_reduce_avg", "all_reduce_prod", "all_reduce_async", "reduce",
       "all_gather", "all_gather_async", "all_gather_functional", "gather",
       "broadcast", "scatter", "reduce_scatter_sum", "reduce_scatter_avg",
       "reduce_scatter_max", "reduce_scatter_list", "alltoall",
       "alltoall_single", "send_recv", "batch_isend_irecv",
       "new_group_sum", "new_group_nonmember", "mesh_mp_sum",
       "mesh_fused_sum"]


@pytest.mark.parametrize("op", OPS)
def test_collective_matches_jax_spmd_per_rank(ranks, op):
    want, arrays, _ = ranks
    for r in range(N):
        np.testing.assert_allclose(arrays[r][op], want[op][r], **TOL,
                                   err_msg=f"{op} on rank {r}")


def test_object_collectives(ranks):
    _, _, info = ranks
    for r in range(N):
        assert info[r]["all_gather_object"] == [{"rank": j}
                                                for j in range(N)]
        assert info[r]["broadcast_object_list"] == ["from 3", 3]
        assert info[r]["scatter_object_list"] == [f"to {r}"]
        assert info[r]["backend"] == "gloo"


def test_all_reduce_gradient_is_the_identity(ranks):
    """``y = x * (r+1)``, all-reduced, then ``sum(y²)``: the gradient
    through the all-reduce is the identity, so ``dx = 2 y (r+1)`` with
    ``y`` the reduced value."""
    _, arrays, _ = ranks
    x, _ = workers.collective_inputs()
    total = sum(x[r] * (r + 1) for r in range(N))
    for r in range(N):
        np.testing.assert_allclose(arrays[r]["grad_value"], total, **TOL)
        np.testing.assert_allclose(arrays[r]["grad"], 2 * total * (r + 1),
                                   **TOL)


def test_subgroups_and_mesh_axes(ranks):
    _, _, info = ranks
    for r in range(N):
        ng = info[r]["new_group"]
        assert ng["ranks"] == ([0, 1] if r < 2 else [2, 3])
        assert ng["rank"] == ng["group_rank"] == r % 2
        assert ng["nranks"] == 2 and not ng["member_of_other"]
        m = info[r]["mesh"]
        assert m["mp"] == [r // 2 * 2, r // 2 * 2 + 1]
        assert m["dp"] == [r % 2, r % 2 + 2]
        assert m["coord"] == {"dp": r // 2, "mp": r % 2}


def test_tcp_store(ranks):
    _, _, info = ranks
    adds = sorted(info[r]["store"]["add"] for r in range(N))
    assert adds[-1] == 10 and len(set(adds)) == N   # 1+2+3+4, atomically
    for r in range(N):
        st = info[r]["store"]
        assert st["get"] == "hello" and st["total"] == 10
        assert st["wait_timeout"] == st["get_timeout"] == "TimeoutError"
        assert st["deleted"]


@pytest.mark.parametrize("case,bad", [("order", 1), ("shape", 3),
                                      ("dtype", 1), ("reduce_op", 2),
                                      ("truncate", 3), ("corrupt", 3)])
def test_sanitizer_raises_before_the_launch(ranks, case, bad):
    """Every rank raises at the disagreeing call (seq 0; the scheduled
    damage at the second call, seq 1, on the last rank) naming rank 0
    and the rank that differs; an agreeing call afterwards runs."""
    _, arrays, info = ranks
    seq = 1 if case in ("truncate", "corrupt") else 0
    x, _ = workers.collective_inputs()
    for r in range(N):
        assert info[r]["sanitizer"][case] == [seq, 0, bad]
        np.testing.assert_allclose(arrays[r]["after_sanitizer"],
                                   x.sum(0), **TOL)
