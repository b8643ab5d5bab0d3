"""The hybrid-parallel topology; counterpart of
``paddle_tpu/distributed/fleet/base/topology.py`` (ref:
``python/paddle/distributed/fleet/base/topology.py``).

:class:`CommunicateTopology` is the reference's cartesian rank grid, as
the JAX package keeps it.  :class:`HybridCommunicateGroup` lays the
world's ranks on a :class:`~..mesh.Mesh` with the axes ``dp, pp,
sharding, sep, cp, ep, mp`` (innermost last) and builds a real
communicator per axis and for the fused ``check`` (dp, pp, sharding) and
``dp_sharding`` groups, every rank making every call in the same order.
Data parallel, sharding, model (tensor) parallel, sep (Ulysses) and
context (ring attention) run; a pipeline or expert degree above 1 raises
``NotImplementedError``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ...communication.group import Group
from ...env import get_rank, get_world_size
from ...mesh import build_mesh, set_mesh

__all__ = ["CommunicateTopology", "HybridCommunicateGroup",
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
# the degrees later slices bring (ROADMAP Queue 1 item 1)
_LATER = {"pipe": "(d) pipelines", "expert": "(d) MoE"}


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

        for n, slice_ in _LATER.items():
            if dim(n) > 1:
                raise NotImplementedError(
                    f"{n} degree {dim(n)} waits for the distributed slice "
                    f"{slice_}")
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

    def get_p2p_groups(self):
        return None  # pipelines wait for a later slice

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
