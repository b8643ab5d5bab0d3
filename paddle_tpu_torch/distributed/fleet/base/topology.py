"""The hybrid-parallel topology; counterpart of
``paddle_tpu/distributed/fleet/base/topology.py`` (ref:
``python/paddle/distributed/fleet/base/topology.py``).

:class:`CommunicateTopology` is the reference's cartesian rank grid, as
the JAX package keeps it.  :class:`HybridCommunicateGroup` lays the
world's ranks on a :class:`~..mesh.Mesh` with the axes ``dp, pp,
sharding, sep, cp, ep, mp`` (innermost last) and builds a real
communicator per axis and for the fused ``check`` (dp, pp, sharding) and
``dp_sharding`` groups, every rank making every call in the same order.
Data parallel, sharding, model (tensor) parallel, sep (Ulysses), context
(ring attention), pipeline and expert parallel run.  A pipeline degree
above 1 with a sharding, sep or cp degree above 1 raises
``NotImplementedError``, and so does an expert degree above 1 with a
pipeline, sharding, model, sep or cp degree above 1.

The expert axis ``ep`` is an axis of its own, as on the JAX mesh: the
batch is split over ``dp`` (and ``sharding``) only, so the ranks of one
ep group see the same tokens, repeat the dense compute and each hold
``E / ep`` of every MoE layer's experts
(``incubate.distributed.models.moe``).

Under a pipeline degree above 1 the pipeline's point-to-point channels
are built with the groups (:meth:`HybridCommunicateGroup.get_p2p_groups`):
one two-rank group per direction and kind along every pipeline line, as
the reference's four-direction p2p groups are, so that activations
(towards the next stage) and gradients (towards the previous one) each
travel a communicator of their own, in order.  The line is a ring: the
last stage's next stage is the first (interleaved schedules hand from
the last rank back to the first).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ...communication.group import Group
from ...env import get_rank, get_world_size
from ...mesh import build_mesh, set_mesh

__all__ = ["CommunicateTopology", "HybridCommunicateGroup", "P2PGroups",
           "get_hybrid_communicate_group"]


class CommunicateTopology:
    """ref: topology.py CommunicateTopology — the cartesian rank grid."""

    def __init__(self, hybrid_group_names: Sequence[str] = ("data", "pipe",
                 "sharding", "sep", "context", "expert", "model"),
                 dims: Sequence[int] = (1, 1, 1, 1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(int(d) for d in dims)
        self._world_size = int(np.prod(self._dims))
        shape = tuple(self._dims)
        self._grid = np.arange(self._world_size).reshape(shape)

    def get_hybrid_group_names(self) -> List[str]:
        return list(self._parallel_names)

    def get_dim(self, axis_name: str) -> int:
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self) -> int:
        return self._world_size

    def get_rank(self, **kwargs) -> int:
        idx = tuple(kwargs[n] for n in self._parallel_names)
        return int(self._grid[idx])

    def get_coord(self, rank: int):
        coords = np.argwhere(self._grid == rank)[0]
        import collections
        Coord = collections.namedtuple("Coord", self._parallel_names)
        return Coord(*[int(c) for c in coords])

    def get_axis_list(self, axis_name: str, index: int) -> List[int]:
        axis = self._parallel_names.index(axis_name)
        sl = [slice(None)] * len(self._dims)
        sl[axis] = index
        return sorted(int(r) for r in self._grid[tuple(sl)].ravel())

    def get_comm_list(self, axis_name: str) -> List[List[int]]:
        axis = self._parallel_names.index(axis_name)
        moved = np.moveaxis(self._grid, axis, -1).reshape(-1, self._dims[axis])
        return [list(map(int, row)) for row in moved]

    def get_rank_from_stage(self, global_rank: int, **kwargs) -> int:
        coord = self.get_coord(global_rank)._asdict()
        coord.update(kwargs)
        return self.get_rank(**coord)

    def get_fused_ranks(self, axis_names: Sequence[str],
                        global_rank: int) -> List[int]:
        """Global ranks of the subgroup spanning ``axis_names`` that
        contains ``global_rank`` (other axes held at its coordinate)."""
        import itertools
        coord = self.get_coord(global_rank)._asdict()
        dims = [range(self.get_dim(a)) for a in axis_names]
        out = []
        for combo in itertools.product(*dims):
            c = dict(coord)
            for a, v in zip(axis_names, combo):
                c[a] = v
            out.append(self.get_rank(**c))
        return sorted(out)


# mesh axis name per reference parallel name
_AXIS_OF = {"data": "dp", "pipe": "pp", "sharding": "sharding",
            "sep": "sep", "context": "cp", "expert": "ep", "model": "mp"}
# what an expert degree above 1 does not compose with yet
_NOT_WITH_EXPERT = {"pipe": "pp", "sharding": "ZeRO stages 1-3",
                    "model": "mp (tensor parallel)",
                    "sep": "sep (Ulysses)", "context": "cp (ring attention)"}
# what a pipeline degree above 1 does not compose with yet
_NOT_WITH_PIPE = {"sharding": "ZeRO stages 1-3", "sep": "sep (Ulysses)",
                  "context": "cp (ring attention)"}


class P2PGroups(NamedTuple):
    """One rank's pipeline channels (ref: ``get_p2p_groups``): the global
    ranks of the previous and next stage on its line (a ring), and the
    two-rank group of each direction and kind."""
    prev_rank: int
    next_rank: int
    send_next_group: Group      # activations to the next stage
    send_prev_group: Group      # gradients to the previous stage
    recv_next_group: Group      # gradients from the next stage
    recv_prev_group: Group      # activations from the previous stage


class HybridCommunicateGroup:
    """ref: topology.py HybridCommunicateGroup: the rank grid on a mesh
    and one group per axis (module docstring)."""

    def __init__(self, topology: CommunicateTopology):
        self._topo = topology
        self.nranks = topology.world_size()
        self.global_rank = get_rank()
        names = topology.get_hybrid_group_names()

        def dim(n):
            return topology.get_dim(n) if n in names else 1

        if dim("expert") > 1:
            for n, what in _NOT_WITH_EXPERT.items():
                if dim(n) > 1:
                    raise NotImplementedError(
                        f"{what} together with an expert degree above 1 "
                        "waits for a later slice of MoE")
        if dim("pipe") > 1:
            for n, what in _NOT_WITH_PIPE.items():
                if dim(n) > 1:
                    raise NotImplementedError(
                        f"{what} together with a pipeline degree above 1 "
                        "waits for a later slice")
        world = get_world_size()
        if self.nranks != world:
            raise ValueError(f"the topology has {self.nranks} ranks, the "
                             f"world {world}")
        self._dp_degree = dim("data")
        self._pp_degree = dim("pipe")
        self._sharding_degree = dim("sharding")
        self._sep_degree = dim("sep")
        self._cp_degree = dim("context")
        self._ep_degree = dim("expert")
        self._mp_degree = dim("model")

        self._mesh = build_mesh({_AXIS_OF[n]: topology.get_dim(n)
                                 for n in names})
        set_mesh(self._mesh)

        coord = topology.get_coord(self.global_rank)
        self._dp_rank = coord.data
        self._pp_rank = coord.pipe
        self._sharding_rank = coord.sharding
        self._sep_rank = getattr(coord, "sep", 0)
        self._cp_rank = getattr(coord, "context", 0)
        self._ep_rank = getattr(coord, "expert", 0)
        self._mp_rank = coord.model

        m = self._mesh
        self._dp_group = m.group("dp", name="dp")
        self._pp_group = m.group("pp", name="pp")
        self._sharding_group = m.group("sharding", name="sharding")
        self._sep_group = m.group("sep", name="sep")
        self._cp_group = m.group("cp", name="cp") if "context" in names \
            else None
        self._ep_group = m.group("ep", name="ep") if "expert" in names \
            else None
        self._mp_group = m.group("mp", name="mp")
        # check group: fused dp+sharding+pp (ref: get_check_parallel_group)
        self._check_group = m.group(("dp", "pp", "sharding"), name="check")
        self._dp_sharding_group = m.group(("dp", "sharding"),
                                          name="dp_sharding")
        self._p2p: Optional[P2PGroups] = None
        self._p2p_channels: List[Tuple[str, int, int, Group]] = []
        if self._pp_degree > 1:
            self._build_p2p_groups()

    def _build_p2p_groups(self) -> None:
        """Every pipeline line's channels, in one order on every rank (a
        collective call): for each line and stage s, the activation group
        s -> s + 1 and the gradient group s + 1 -> s (indices mod the
        degree)."""
        from ...communication.group import _make_group
        n = self._pp_degree
        mine: Dict[Tuple[str, int, int], Group] = {}
        for line in self._mesh.comm_lists("pp"):
            # comm_lists sorts each line; the pp coordinate orders it too
            line = sorted(line, key=lambda r: self._topo.get_coord(r).pipe)
            for s in range(n):
                a, b = line[s], line[(s + 1) % n]
                for kind, src, dst in (("act", a, b), ("grad", b, a)):
                    g = _make_group([src, dst], name=f"pp_{kind}")
                    self._p2p_channels.append((kind, src, dst, g))
                    if self.global_rank in (src, dst):
                        mine[(kind, src, dst)] = g
        me = self.global_rank
        prev = self.get_rank_from_stage((self._pp_rank - 1) % n)
        nxt = self.get_rank_from_stage((self._pp_rank + 1) % n)
        self._p2p = P2PGroups(
            prev_rank=prev, next_rank=nxt,
            send_next_group=mine[("act", me, nxt)],
            send_prev_group=mine[("grad", me, prev)],
            recv_next_group=mine[("grad", nxt, me)],
            recv_prev_group=mine[("act", prev, me)])

    @property
    def topology(self) -> CommunicateTopology:
        return self._topo

    def get_parallel_mode(self) -> str:
        # ref returns enum ParallelMode; a string keeps the same information
        if self._mp_degree == 1 and self._pp_degree == 1 and \
                self._sharding_degree == 1:
            return "DATA_PARALLEL"
        if self._sharding_degree > 1 and self._mp_degree == 1 and \
                self._pp_degree == 1:
            return "SHARDING_PARALLEL"
        if self._pp_degree > 1:
            return "PIPELINE_PARALLEL"
        return "TENSOR_PARALLEL"

    def get_global_rank(self) -> int:
        return self.global_rank

    # --- data parallel -------------------------------------------------
    def get_data_parallel_rank(self) -> int:
        return self._dp_rank

    def get_data_parallel_world_size(self) -> int:
        return self._dp_degree

    def get_data_parallel_group(self) -> Group:
        return self._dp_group

    def get_data_parallel_group_src_rank(self) -> int:
        return self._dp_group.ranks[0]

    # --- model (tensor) parallel ---------------------------------------
    def get_model_parallel_rank(self) -> int:
        return self._mp_rank

    def get_model_parallel_world_size(self) -> int:
        return self._mp_degree

    def get_model_parallel_group(self) -> Group:
        return self._mp_group

    def get_model_parallel_group_src_rank(self) -> int:
        return self._mp_group.ranks[0]

    # --- pipeline parallel ---------------------------------------------
    def get_stage_id(self) -> int:
        return self._pp_rank

    def get_pipe_parallel_rank(self) -> int:
        return self._pp_rank

    def get_pipe_parallel_world_size(self) -> int:
        return self._pp_degree

    def get_pipe_parallel_group(self) -> Group:
        return self._pp_group

    def is_first_stage(self) -> bool:
        return self._pp_rank == 0

    def is_last_stage(self) -> bool:
        return self._pp_rank == self._pp_degree - 1

    def get_p2p_groups(self) -> Optional[P2PGroups]:
        """This rank's pipeline channels (:class:`P2PGroups`); ``None``
        at a pipeline degree of 1."""
        return self._p2p

    def p2p_channels(self) -> List[Tuple[str, int, int, Group]]:
        """Every line's channels ``(kind, src, dst, group)`` in the order
        they were built (the same on every rank)."""
        return list(self._p2p_channels)

    # --- sharding parallel ---------------------------------------------
    def get_sharding_parallel_rank(self) -> int:
        return self._sharding_rank

    def get_sharding_parallel_world_size(self) -> int:
        return self._sharding_degree

    def get_sharding_parallel_group(self) -> Group:
        return self._sharding_group

    def get_sharding_parallel_group_src_rank(self) -> int:
        return self._sharding_group.ranks[0]

    # --- sep (Ulysses sequence parallel) -------------------------------
    def get_sep_parallel_rank(self) -> int:
        return self._sep_rank

    def get_sep_parallel_world_size(self) -> int:
        return self._sep_degree

    def get_sep_parallel_group(self) -> Group:
        return self._sep_group

    # --- cp (ring / context parallel) ----------------------------------
    def get_context_parallel_rank(self) -> int:
        return self._cp_rank

    def get_context_parallel_world_size(self) -> int:
        return self._cp_degree

    def get_context_parallel_group(self) -> Group:
        return self._cp_group

    # --- expert parallel (MoE) -----------------------------------------
    def get_expert_parallel_rank(self) -> int:
        return self._ep_rank

    def get_expert_parallel_world_size(self) -> int:
        return self._ep_degree

    def get_expert_parallel_group(self) -> Group:
        return self._ep_group

    # --- fused groups ---------------------------------------------------
    def get_check_parallel_group(self, sharding: bool = False) -> Group:
        return self._check_group

    def get_dp_sharding_parallel_group(self) -> Group:
        return self._dp_sharding_group

    def get_rank_from_stage(self, stage_id: int, **kwargs) -> int:
        return self._topo.get_rank_from_stage(self.global_rank,
                                              pipe=stage_id, **kwargs)

    @property
    def mesh(self):
        return self._mesh


_hcg: Optional[HybridCommunicateGroup] = None


def _set_hcg(hcg: HybridCommunicateGroup):
    global _hcg
    _hcg = hcg


def get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _hcg


def _clear_hcg():
    global _hcg
    _hcg = None
