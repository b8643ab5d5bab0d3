"""Communication groups; counterpart of
``paddle_tpu/distributed/communication/group.py``.

A :class:`Group` wraps a ``torch.distributed`` process group: NCCL when
``init_parallel_env`` ran on the card, gloo when it ran with
``device="cpu"``.  Where the JAX package's group is a view of mesh axes
that one controller drives (its collectives are lax ops inside
``shard_map``), here each rank is a process of its own and the group is
a real communicator; ranks are global ranks.  Creating a group is
collective: every rank of the world calls :func:`new_group` (and builds
a mesh's axis groups) in the same order, as upstream Paddle requires.
"""
from __future__ import annotations

import datetime
from typing import Dict, List, Optional, Sequence

import torch.distributed as dist

__all__ = ["Group", "ReduceOp", "get_group", "new_group",
           "destroy_process_group", "axis_group"]


class ReduceOp:
    """ref: ``paddle/distributed/communication/reduce.py`` ReduceOp."""
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


_TORCH_OP = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
             ReduceOp.MIN: dist.ReduceOp.MIN,
             ReduceOp.PROD: dist.ReduceOp.PRODUCT,
             ReduceOp.AVG: dist.ReduceOp.AVG}


def torch_op(op) -> "dist.ReduceOp":
    try:
        return _TORCH_OP[op]
    except KeyError:
        raise ValueError(f"unsupported ReduceOp {op}") from None


class Group:
    """A communication subgroup over the global ``ranks``.
    ``process_group`` is the torch process group (``None`` on a rank
    outside the group)."""

    def __init__(self, ranks: List[int], gid: int = 0, pg=None,
                 name: str = ""):
        self._ranks = list(ranks)
        self._id = gid
        self._pg = pg
        self._name = name or f"group_{gid}"

    @property
    def id(self) -> int:
        return self._id

    @property
    def ranks(self) -> List[int]:
        return self._ranks

    @property
    def nranks(self) -> int:
        return len(self._ranks)

    world_size = nranks

    @property
    def rank(self) -> int:
        """This process's rank within the group (-1 if not a member)."""
        from ..env import get_rank
        return self.get_group_rank(get_rank())

    @property
    def name(self) -> str:
        return self._name

    @property
    def key(self) -> str:
        """The group's name with its ranks: equal on every member, and
        different for two subgroups of one mesh axis."""
        return f"{self._name}[{','.join(map(str, self._ranks))}]"

    @property
    def process_group(self):
        return self._pg

    def get_group_rank(self, global_rank: int) -> int:
        return (self._ranks.index(global_rank)
                if global_rank in self._ranks else -1)

    def global_rank(self, rank: int) -> int:
        """A peer named either by its global rank (Paddle's convention)
        or, when that is not a member, by its rank in the group."""
        if rank in self._ranks:
            return rank
        if 0 <= rank < self.nranks:
            return self._ranks[rank]
        raise ValueError(f"rank {rank} is not in {self!r}")

    def is_member(self) -> bool:
        return self.rank >= 0

    def __repr__(self):
        return (f"Group(id={self._id}, nranks={self.nranks}, "
                f"ranks={self._ranks}, name={self._name})")


_groups: Dict[int, Group] = {}
_next_gid = [1]


def _require_init() -> None:
    if not dist.is_initialized():
        raise RuntimeError("the process group is not initialized: call "
                           "paddle_tpu_torch.distributed.init_parallel_env "
                           "(or fleet.init) first")


def _world_group() -> Group:
    g = _groups.get(0)
    if g is None:
        _require_init()
        g = Group(list(range(dist.get_world_size())), gid=0,
                  pg=dist.group.WORLD, name="default")
        _groups[0] = g
    return g


def _reset_groups() -> None:
    _groups.clear()
    _next_gid[0] = 1


def _timeout(timeout) -> Optional[datetime.timedelta]:
    if timeout is None or isinstance(timeout, datetime.timedelta):
        return timeout
    return datetime.timedelta(seconds=float(timeout))


def _make_group(ranks: Sequence[int], name: str = "", backend=None,
                timeout=None) -> Group:
    """One collective ``new_group`` call (every world rank makes it)."""
    _require_init()
    ranks = sorted(int(r) for r in ranks)
    if backend not in (None, "nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: use 'nccl' or 'gloo'")
    pg = dist.new_group(ranks, timeout=_timeout(timeout), backend=backend)
    gid = _next_gid[0]
    _next_gid[0] += 1
    member = dist.get_rank() in ranks
    g = Group(ranks, gid=gid, pg=pg if member else None, name=name)
    _groups[gid] = g
    return g


def get_group(gid: int = 0) -> Optional[Group]:
    if gid == 0:
        return _world_group()
    return _groups.get(gid)


def new_group(ranks: Optional[Sequence[int]] = None, backend: str = None,
              timeout=None) -> Group:
    """ref: ``paddle.distributed.new_group``.  A group over the given
    global ranks (all ranks when ``None``); every rank of the world makes
    the call, members and others alike.  ``timeout`` is in seconds (or a
    ``timedelta``)."""
    _require_init()
    if ranks is None:
        ranks = range(dist.get_world_size())
    return _make_group(ranks, backend=backend, timeout=timeout)


def axis_group(axis_name, mesh=None, name: str = "",
               ranks: Optional[Sequence[int]] = None) -> Group:
    """This rank's group along one mesh axis (or a fused tuple of axes);
    ``ranks``, when given, must be that group's global ranks."""
    from ..mesh import ensure_mesh
    mesh = mesh or ensure_mesh()
    g = mesh.group(axis_name, name=name)
    if ranks is not None and sorted(int(r) for r in ranks) != g.ranks:
        raise ValueError(f"ranks {sorted(ranks)} are not this rank's "
                         f"{axis_name!r} group {g.ranks}")
    return g


def _resolve_group(group) -> Group:
    if group is None:
        return _world_group()
    if isinstance(group, int):
        g = get_group(group)
        if g is None:
            raise ValueError(f"no group with id {group}")
        return g
    return group


def destroy_process_group(group=None) -> None:
    """``None``: tear the whole runtime down (every group, the mesh and
    the process group); else destroy one subgroup."""
    if group is None:
        from .. import env, mesh
        from ..fleet.base.topology import _clear_hcg
        if dist.is_initialized():
            dist.destroy_process_group()
        _reset_groups()
        mesh.reset_mesh()
        _clear_hcg()
        env._clear()
        return
    g = _resolve_group(group)
    if g.process_group is not None and g.id != 0:
        dist.destroy_process_group(g.process_group)
    _groups.pop(g.id, None)
