"""The rank grid; counterpart of ``paddle_tpu/distributed/mesh.py``.

The JAX package's mesh is a ``jax.sharding.Mesh`` over devices that one
controller drives.  Here a :class:`Mesh` is a grid of global ranks (one
process per card) with named axes, outermost first, ``("dp", "pp",
"sharding", "sep", "mp")`` with ``mp`` innermost as there.  A
communication group along an axis, or a fused tuple of axes, is built on
first use by :meth:`Mesh.group`: one ``torch.distributed`` subgroup per
coordinate of the other axes, every rank making every call in the same
order, and this rank keeps its own.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["HYBRID_AXES", "Mesh", "build_mesh", "get_mesh", "set_mesh",
           "ensure_mesh", "reset_mesh"]

# canonical axis order, outermost -> innermost (ref: fleet/base/topology.py
# HybridCommunicateGroup order ["data", "pipe", "sharding", "sep", "model"])
HYBRID_AXES = ("dp", "pp", "sharding", "sep", "mp")


def _names(axis_name) -> Tuple[str, ...]:
    return tuple(axis_name) if isinstance(axis_name, (tuple, list)) \
        else (axis_name,)


class Mesh:
    """Global ranks laid out on named axes (``grid[i, j, ...]`` is the
    rank at those coordinates).  ``process_mesh`` is the semi-auto
    ``ProcessMesh`` this grid was made for, if any."""

    process_mesh = None

    def __init__(self, grid, axis_names: Sequence[str]):
        self._grid = np.asarray(grid, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self._grid.ndim != len(self.axis_names):
            raise ValueError(f"{self._grid.ndim}-d grid for axes "
                             f"{self.axis_names}")
        self._groups: Dict[Tuple[str, ...], object] = {}

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self._grid.shape))

    def coord(self, rank: int) -> Dict[str, int]:
        hit = np.argwhere(self._grid == rank)
        if not len(hit):
            raise ValueError(f"rank {rank} is not on the mesh")
        return dict(zip(self.axis_names, (int(c) for c in hit[0])))

    def comm_lists(self, axis_name) -> List[List[int]]:
        """The rank lists of every group along ``axis_name`` (fused
        axes: the product of their degrees per group)."""
        names = _names(axis_name)
        idx = [self.axis_names.index(a) for a in names]
        rest = [i for i in range(self._grid.ndim) if i not in idx]
        moved = np.transpose(self._grid, rest + idx)
        size = int(np.prod([self._grid.shape[i] for i in idx]))
        return [sorted(int(r) for r in row)
                for row in moved.reshape(-1, size)]

    def group(self, axis_name, name: str = ""):
        """This rank's group along ``axis_name``, made on first use (a
        collective call: every rank of the world makes it)."""
        import torch.distributed as dist
        from .communication.group import _make_group
        names = _names(axis_name)
        g = self._groups.get(names)
        if g is None:
            world = dist.get_world_size() if dist.is_initialized() else 1
            if sorted(self._grid.ravel().tolist()) != list(range(world)):
                raise ValueError(f"the mesh's ranks are not the world's "
                                 f"{world}: its groups cannot be built")
            me = dist.get_rank() if dist.is_initialized() else 0
            label = name or "_".join(names)
            for ranks in self.comm_lists(names):
                made = _make_group(ranks, name=label)
                if me in ranks:
                    g = made
            self._groups[names] = g
        return g

    def __repr__(self):
        return f"Mesh({self.shape})"


_global_mesh: Optional[Mesh] = None


def _world_size() -> int:
    from .env import get_world_size
    return get_world_size()


def build_mesh(axes: Dict[str, int], devices: Optional[Sequence] = None
               ) -> Mesh:
    """A mesh from ``{axis: degree}`` over the global ranks ``devices``
    (all ranks when ``None``).  The degrees multiply to the rank count;
    one degree of -1 absorbs the remainder."""
    ranks = list(devices) if devices is not None \
        else list(range(_world_size()))
    n = len(ranks)
    names = list(axes)
    degrees = [int(axes[a]) for a in names]
    if any(d == -1 for d in degrees):
        known = int(np.prod([d for d in degrees if d != -1]))
        if n % known:
            raise ValueError(f"rank count {n} not divisible by {known}")
        degrees = [n // known if d == -1 else d for d in degrees]
    total = int(np.prod(degrees)) if degrees else 1
    if total != n:
        raise ValueError(
            f"mesh degrees {dict(zip(names, degrees))} multiply to {total} "
            f"but there are {n} ranks")
    return Mesh(np.array(ranks).reshape(degrees), names)


def set_mesh(mesh: Mesh) -> None:
    global _global_mesh
    _global_mesh = mesh


def get_mesh() -> Optional[Mesh]:
    return _global_mesh


def ensure_mesh(axes: Optional[Dict[str, int]] = None) -> Mesh:
    """The global mesh, built on first use (default: every rank on one
    ``dp`` axis, as the reference's ``init_parallel_env`` does)."""
    global _global_mesh
    if _global_mesh is None:
        _global_mesh = build_mesh(axes or {"dp": _world_size()})
    return _global_mesh


def reset_mesh() -> None:
    global _global_mesh
    _global_mesh = None

