"""The semi-auto API; counterpart of
``paddle_tpu/distributed/auto_parallel/api.py`` (ref:
``python/paddle/distributed/auto_parallel/api.py``, ``process_mesh.py``,
``placement_type.py``).

A :class:`ProcessMesh` is an N-d grid of global ranks with named dims
over the port's rank grid (``distributed.mesh.Mesh``: one process per
card, a dim's groups built by ``Mesh.group``).  The JAX package's arrays
are global and GSPMD places them; here **a tensor keeps only this
rank's local piece**, and the mesh, the placements and the global shape
go in a recorded :class:`DistAttr`, read through :func:`get_dist_attr`
and :func:`global_shape`.  So ``t.shape`` is local (the JAX package's is
global); :func:`unshard_dtensor` gives the global value.

* ``Shard(d)`` keeps this rank's contiguous chunk of dimension ``d``
  along a mesh dim (several mesh dims on one tensor dim: the first is
  the outer split); a dimension that does not divide raises.
* ``Replicate()`` keeps the whole value.
* ``Partial()`` keeps the value on the mesh dim's rank 0 and zeros on
  the others, so the global value (their sum) is exactly the data, as
  the JAX package materialises it reduced.

:func:`reshard` between placements on one mesh, or between two meshes
over the same ranks, makes the global value (``all_gather`` along
sharded dims, ``all_reduce`` along partial ones: exact) and keeps the
new local piece (a local slice).  A mesh over other ranks raises
``NotImplementedError``.  Every collective goes through
``distributed.communication`` (the sanitizer and the fault point).

**Parameter placements.**  The JAX package leaves completion to GSPMD;
the port has no propagation, so a placed parameter changes how its layer
computes, by the rule table of :func:`check_placements`: an
``nn.Linear`` weight ``[in, out]`` with ``Shard(1)`` on one mesh dim
(its bias ``Shard(0)`` on that dim or replicated) computes as the
column half of the mp layers (``column_linear``: fp32 partial products
of the input's gradient summed over the dim's group); with ``Shard(0)``
(its bias replicated) as the row half (``_RowLinear``: the partial
products summed in fp32).  ``Replicate`` everywhere changes nothing.
Any other placement on a parameter (a dim the table does not know, a
layer type it lacks, a data dim ``dp`` / ``sharding``, ``Partial``)
raises ``NotImplementedError`` naming the parameter and the placement.
A split parameter's gradient stays split; the training step averages
over the mesh's data dims only (``jit.TrainStep``).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["ProcessMesh", "Placement", "Shard", "Replicate", "Partial",
           "DistAttr", "shard_tensor", "dtensor_from_fn", "reshard",
           "unshard_dtensor", "shard_layer", "shard_optimizer",
           "shard_dataloader", "get_mesh", "set_mesh", "DistModel",
           "to_static", "get_dist_attr", "global_shape",
           "check_placements"]

# mesh dims that shard the batch (jit.TrainStep's data axes)
DATA_DIMS = ("dp", "sharding")


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------

class Placement:
    def is_shard(self, dim=None) -> bool:
        return False

    def is_replicate(self) -> bool:
        return False

    def is_partial(self) -> bool:
        return False


class Shard(Placement):
    """Tensor dim ``dim`` is sharded over this mesh dimension."""

    def __init__(self, dim: int):
        self.dim = int(dim)

    def is_shard(self, dim=None) -> bool:
        return dim is None or dim == self.dim

    def get_dim(self) -> int:
        return self.dim

    def __repr__(self):
        return f"Shard(dim={self.dim})"

    def __eq__(self, other):
        return isinstance(other, Shard) and other.dim == self.dim

    def __hash__(self):
        return hash(("S", self.dim))


class Replicate(Placement):
    def is_replicate(self) -> bool:
        return True

    def __repr__(self):
        return "Replicate()"

    def __eq__(self, other):
        return isinstance(other, Replicate)

    def __hash__(self):
        return hash("R")


class Partial(Placement):
    """A pending sum over the mesh dim: the value on the dim's rank 0,
    zeros on the others (module docstring).  Only ``"sum"`` is
    held."""

    def __init__(self, reduce_type: str = "sum"):
        self.reduce_type = reduce_type

    def is_partial(self) -> bool:
        return True

    def __repr__(self):
        return f"Partial({self.reduce_type})"


# ---------------------------------------------------------------------------
# ProcessMesh
# ---------------------------------------------------------------------------

class ProcessMesh:
    """ref: ``process_mesh.py`` ProcessMesh: an N-d grid of global ranks
    with named dims, over the port's rank grid (:attr:`rank_mesh`, the
    counterpart of the JAX package's ``jax_mesh``).  A rank beyond the
    world size raises."""

    def __init__(self, mesh, dim_names: Optional[Sequence[str]] = None,
                 shape=None, process_ids=None):
        from ..env import get_world_size
        from ..mesh import Mesh
        arr = np.asarray(mesh, dtype=np.int64)
        if dim_names is None:
            dim_names = [f"d{i}" for i in range(arr.ndim)]
        self._ranks = arr
        self._dim_names = list(dim_names)
        world = get_world_size()
        if arr.max() >= world:
            raise ValueError(f"ProcessMesh names rank {int(arr.max())} but "
                             f"the world has only {world} ranks")
        self._rank_mesh = Mesh(arr, self._dim_names)
        self._rank_mesh.process_mesh = self

    @property
    def shape(self) -> List[int]:
        return list(self._ranks.shape)

    @property
    def ndim(self) -> int:
        return self._ranks.ndim

    @property
    def dim_names(self) -> List[str]:
        return list(self._dim_names)

    @property
    def mesh(self):
        return self._ranks

    @property
    def process_ids(self) -> List[int]:
        return [int(r) for r in self._ranks.ravel()]

    @property
    def rank_mesh(self):
        """The ``distributed.mesh.Mesh`` over these ranks and dims."""
        return self._rank_mesh

    def get_dim_size(self, name: str) -> int:
        return self._ranks.shape[self._dim_names.index(name)]

    def get_mesh_with_dim(self, name: str):
        axis = self._dim_names.index(name)
        return ProcessMesh(np.moveaxis(self._ranks, axis, 0),
                           [name] + [n for n in self._dim_names
                                     if n != name])

    def __eq__(self, other):
        return (isinstance(other, ProcessMesh)
                and np.array_equal(self._ranks, other._ranks)
                and self._dim_names == other._dim_names)

    def __repr__(self):
        return (f"ProcessMesh(shape={self.shape}, "
                f"dim_names={self._dim_names})")


def set_mesh(mesh: ProcessMesh):
    """Install ``mesh``'s rank grid as the global one
    (``distributed.get_mesh()``), which ``Engine`` / ``to_static`` and
    ``fleet`` read; the grid remembers ``mesh``, so replacing or
    resetting the grid uninstalls it."""
    from ..mesh import set_mesh as _set_rank_mesh
    _set_rank_mesh(mesh.rank_mesh)


def get_mesh() -> Optional[ProcessMesh]:
    """The installed ``ProcessMesh``: the one whose rank grid is the
    global one, else ``None``."""
    from ..mesh import get_mesh as _get_rank_mesh
    return getattr(_get_rank_mesh(), "process_mesh", None)


class DistAttr:
    """ref: DistAttr: the (mesh, placements) pair; ``shard_tensor`` also
    records the tensor's ``global_shape`` (None until then)."""

    def __init__(self, mesh: ProcessMesh, placements: Sequence[Placement]):
        self.process_mesh = mesh
        self.placements = list(placements)
        self.global_shape = None

    def __repr__(self):
        return (f"DistAttr({self.process_mesh}, {self.placements}, "
                f"global_shape={self.global_shape})")


def get_dist_attr(tensor) -> Optional[DistAttr]:
    """The :class:`DistAttr` ``shard_tensor`` recorded on ``tensor``
    (``None`` for a plain tensor)."""
    return getattr(tensor, "_dist_attr", None)


def global_shape(tensor) -> List[int]:
    """``tensor``'s global shape (its own shape when it is not
    distributed)."""
    da = get_dist_attr(tensor)
    return list(da.global_shape) if da is not None else list(tensor.shape)


# ---------------------------------------------------------------------------
# local pieces and global values
# ---------------------------------------------------------------------------

def _full(mesh: ProcessMesh, placements) -> List[Placement]:
    placements = list(placements)
    if len(placements) > mesh.ndim:
        raise ValueError(f"{len(placements)} placements for a "
                         f"{mesh.ndim}-d mesh")
    for pl in placements:
        if isinstance(pl, Partial) and pl.reduce_type != "sum":
            raise NotImplementedError(f"{pl}: only a pending sum is held")
    return placements + [Replicate()] * (mesh.ndim - len(placements))


def _coord(mesh: ProcessMesh) -> dict:
    from ..env import get_rank
    return mesh.rank_mesh.coord(get_rank())


def _local(full: torch.Tensor, mesh: ProcessMesh, placements
           ) -> torch.Tensor:
    """This rank's piece of the global value ``full``."""
    coord = _coord(mesh)
    x = full
    for i, pl in enumerate(placements):
        n, c = mesh.shape[i], coord[mesh.dim_names[i]]
        if isinstance(pl, Shard):
            d = pl.dim % full.dim()
            if x.shape[d] % n:
                raise ValueError(
                    f"dimension {pl.dim} ({x.shape[d]}) of a tensor of "
                    f"global shape {list(full.shape)} does not split over "
                    f"mesh dim {mesh.dim_names[i]!r} of {n} ranks")
            k = x.shape[d] // n
            x = x.narrow(d, c * k, k)
        elif isinstance(pl, Partial) and c != 0:
            x = torch.zeros_like(x)
    return x.clone()


def _dim_group(mesh: ProcessMesh, i: int):
    return mesh.rank_mesh.group(mesh.dim_names[i])


def _global(local: torch.Tensor, mesh: ProcessMesh, placements
            ) -> torch.Tensor:
    """The global value from every rank's ``local`` piece (a collective
    call on every rank of the mesh)."""
    from ..communication import all_gather, all_reduce
    x = local
    for i in reversed(range(len(placements))):
        pl, n = placements[i], mesh.shape[i]
        if n == 1 or pl.is_replicate():
            continue
        group = _dim_group(mesh, i)
        name = mesh.dim_names[i]
        if isinstance(pl, Shard):
            parts: list = []
            all_gather(parts, x.contiguous(), group=group)
            at = [mesh.rank_mesh.coord(r)[name] for r in group.ranks]
            ordered = [None] * n
            for c, part in zip(at, parts):
                ordered[c] = part
            x = torch.cat(ordered, dim=pl.dim % x.dim())
        else:
            x = x.clone()
            all_reduce(x, group=group)
    return x


def _attach(t: torch.Tensor, mesh: ProcessMesh, placements, shape) -> None:
    t._dist_attr = DistAttr(mesh, placements)
    t._dist_attr.global_shape = [int(s) for s in shape]


def _torch_dtype(dtype):
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype).replace("paddle.", ""))


# ---------------------------------------------------------------------------
# API
# ---------------------------------------------------------------------------

def shard_tensor(data, mesh: ProcessMesh, placements: Sequence[Placement],
                 dtype=None, place=None, stop_gradient=None
                 ) -> torch.Tensor:
    """ref: api.py shard_tensor: ``data`` (its global value) cut to this
    rank's piece under ``placements``, with the dist attr recorded.  A
    torch tensor (a parameter too) keeps its identity: its ``.data``
    becomes the piece, so a layer and an optimizer built on it see the
    change; a tensor that already has a dist attr is resharded.  Other
    data becomes a tensor on ``place`` (the device rule: ``None`` is the
    card)."""
    from ...device import default_device
    placements = _full(mesh, placements)
    dtype = _torch_dtype(dtype)
    if isinstance(data, torch.Tensor):
        t = data
        value = t.detach()
        da = get_dist_attr(t)
        if da is not None:
            _check_same_ranks(da.process_mesh, mesh)
            value = _global(value, da.process_mesh, da.placements)
        if place is not None:
            value = value.to(default_device(place))
    else:
        value = torch.as_tensor(np.asarray(data),
                                device=default_device(place))
        t = value
    if dtype is not None:
        value = value.to(dtype)
    local = _local(value, mesh, placements)
    with torch.no_grad():
        t.data = local
    _attach(t, mesh, placements, value.shape)
    if stop_gradient is not None and t.is_leaf:
        t.requires_grad_(not stop_gradient)
    return t


def dtensor_from_fn(fn: Callable, mesh: ProcessMesh,
                    placements: Sequence[Placement], *args, **kwargs):
    """ref: dtensor_from_fn: build with ``fn``, then shard."""
    return shard_tensor(fn(*args, **kwargs), mesh, placements)


def _check_same_ranks(old: ProcessMesh, new: ProcessMesh) -> None:
    if sorted(old.process_ids) != sorted(new.process_ids):
        raise NotImplementedError(
            f"reshard from {old} over ranks {old.process_ids} to {new} over "
            f"ranks {new.process_ids}: a mesh over other ranks")


def reshard(tensor: torch.Tensor, mesh: ProcessMesh,
            placements: Sequence[Placement]) -> torch.Tensor:
    """ref: reshard: a new tensor holding this rank's piece of
    ``tensor``'s global value under ``placements`` on ``mesh``, a mesh
    over the same ranks (module docstring); ``tensor`` is unchanged."""
    placements = _full(mesh, placements)
    da = get_dist_attr(tensor)
    value = tensor.detach()
    if da is not None:
        _check_same_ranks(da.process_mesh, mesh)
        value = _global(value, da.process_mesh, da.placements)
    out = _local(value, mesh, placements)
    _attach(out, mesh, placements, value.shape)
    if tensor.requires_grad and out.is_floating_point():
        out.requires_grad_(True)
    return out


def unshard_dtensor(tensor: torch.Tensor) -> torch.Tensor:
    """ref: unshard_dtensor: the global value as a plain tensor (a
    collective call when ``tensor`` is distributed)."""
    da = get_dist_attr(tensor)
    if da is None:
        return tensor
    out = _global(tensor.detach(), da.process_mesh, da.placements)
    if out.data_ptr() == tensor.data_ptr():
        out = out.clone()
    if tensor.requires_grad and out.is_floating_point():
        out.requires_grad_(True)
    return out


def shard_layer(layer: torch.nn.Module, process_mesh: ProcessMesh,
                shard_fn: Optional[Callable] = None,
                input_fn: Optional[Callable] = None,
                output_fn: Optional[Callable] = None) -> torch.nn.Module:
    """ref: api.py shard_layer: ``shard_fn(name, sublayer, mesh)`` for
    every sublayer (default: every parameter replicated); ``input_fn`` /
    ``output_fn`` as forward pre- / post-hooks."""
    if shard_fn is None:
        def shard_fn(name, sublayer, mesh):
            for p in sublayer.parameters(recurse=False):
                shard_tensor(p, mesh, [Replicate()
                                       for _ in range(mesh.ndim)])
    for name, sub in layer.named_modules():
        shard_fn(name, sub, process_mesh)
    if input_fn is not None:
        layer.register_forward_pre_hook(
            lambda lay, inp: input_fn(inp, process_mesh))
    if output_fn is not None:
        layer.register_forward_hook(
            lambda lay, inp, out: output_fn(out, process_mesh))
    return layer


def shard_optimizer(optimizer, shard_fn=None):
    """ref: api.py shard_optimizer: the optimizer's state follows its
    parameters' pieces (the states are made from the local parameters);
    ``shard_fn`` is recorded and read by nothing, as in the JAX
    package."""
    opt = getattr(optimizer, "_inner_opt", optimizer)
    opt._auto_parallel_sharded = True
    if shard_fn is not None:
        opt._auto_parallel_shard_fn = shard_fn
    return optimizer


def shard_dataloader(dataloader, meshes, shard_dims=None, input_keys=None):
    """ref: api.py shard_dataloader: a pass-through (the training step
    takes each rank's rows of the global batch), annotated."""
    dataloader._auto_parallel_meshes = meshes
    return dataloader


# ---------------------------------------------------------------------------
# the parameter rule table
# ---------------------------------------------------------------------------

def _splits(name: str, p) -> list:
    """``[(mesh dim index, tensor dim, mesh)]`` of ``p``'s non-replicated
    placements; raises for a ``Partial`` or a data dim."""
    da = get_dist_attr(p)
    if da is None:
        return []
    out = []
    for i, pl in enumerate(da.placements):
        if pl.is_replicate():
            continue
        dim = da.process_mesh.dim_names[i]
        if not isinstance(pl, Shard) or dim in DATA_DIMS:
            raise NotImplementedError(
                f"parameter {name}: placement {pl} on mesh dim {dim!r} "
                f"(the port shards a parameter over a model dim only, by "
                "the rule table of auto_parallel.api)")
        out.append((i, pl.dim % p.dim(), da.process_mesh))
    return out


def _linear_rule(layer, prefix: str):
    """``(kind, mesh, mesh dim)`` of a ``Linear``'s placed parameters
    (kind ``"column"`` or ``"row"``), ``None`` when replicated; raises
    ``NotImplementedError`` outside the table."""
    name = (prefix + "." if prefix else "")
    w = _splits(name + "weight", layer.weight)
    b = _splits(name + "bias", layer.bias) if layer.bias is not None else []
    if not w and not b:
        return None
    if len(w) == 1 and w[0][1] == 1 and (
            not b or (len(b) == 1 and b[0][1] == 0 and b[0][0] == w[0][0]
                      and b[0][2] == w[0][2])):
        kind = "column"
    elif len(w) == 1 and w[0][1] == 0 and not b:
        kind = "row"
    else:
        da = get_dist_attr(layer.weight)
        raise NotImplementedError(
            f"parameter {name}weight placements "
            f"{da.placements if da is not None else None} with "
            f"{name}bias placements "
            f"{get_dist_attr(layer.bias).placements if b else None}: the "
            "rule table takes a Linear weight Shard(1) (bias Shard(0) on "
            "the same mesh dim, or replicated) or Shard(0) (bias "
            "replicated) on one mesh dim")
    i, _, mesh = w[0]
    ranks = mesh.rank_mesh.comm_lists(mesh.dim_names[i])
    coords = [[mesh.rank_mesh.coord(r)[mesh.dim_names[i]] for r in row]
              for row in ranks]
    if any(c != list(range(len(c))) for c in coords):
        raise NotImplementedError(
            f"parameter {name}weight: mesh dim {mesh.dim_names[i]!r} orders "
            "its ranks other than by rank number")
    return kind, mesh, i


def check_placements(model: torch.nn.Module) -> None:
    """Raise ``NotImplementedError`` for a placed parameter outside the
    rule table (module docstring), naming it and its placement."""
    from ...nn.layers import Linear
    for mname, mod in model.named_modules():
        own = [(n, p) for n, p in mod.named_parameters(recurse=False)
               if get_dist_attr(p) is not None]
        if not own:
            continue
        if isinstance(mod, Linear):
            _linear_rule(mod, mname)
            continue
        for n, p in own:
            full = f"{mname}.{n}" if mname else n
            if _splits(full, p):
                raise NotImplementedError(
                    f"parameter {full} of a {type(mod).__name__}: placements "
                    f"{get_dist_attr(p).placements} (the rule table holds "
                    "nn.Linear only)")


def placed_linear(layer, x: torch.Tensor) -> torch.Tensor:
    """``Linear.forward`` with placed parameters: the column or row half
    of the mp layers over the mesh dim's group (module docstring)."""
    from ...amp import cast
    from ...nn import functional as F
    from ..fleet.meta_parallel.parallel_layers.mp_layers import (
        _RowLinear, column_linear)
    from ..fleet.meta_parallel.parallel_layers.mp_ops import _c_split
    attrs = (get_dist_attr(layer.weight), get_dist_attr(layer.bias))
    cached = getattr(layer, "_placement_rule", None)
    if cached is None or cached[0] != tuple(map(id, attrs)):
        cached = (tuple(map(id, attrs)),
                  _linear_rule(layer, type(layer).__name__), attrs)
        layer._placement_rule = cached
    rule = cached[1]
    if rule is None or rule[1].shape[rule[2]] == 1:
        return F.linear(x, layer.weight, layer.bias)
    kind, mesh, i = rule
    group = _dim_group(mesh, i)
    w, b = layer.weight, layer.bias
    if kind == "column":
        if b is not None and not _splits("bias", b):
            b = _c_split(b, group)       # a replicated bias: its columns
        (y,) = column_linear(x, [(w, b)], group)
        return y
    if x.shape[-1] != w.shape[0]:
        x = _c_split(x, group)
    x, w = cast("linear", x, w)
    y = _RowLinear.apply(x, w, group, False)
    return y + b.to(y.dtype) if b is not None else y


# ---------------------------------------------------------------------------
# DistModel / to_static
# ---------------------------------------------------------------------------

def _step_mesh():
    """The rank grid a training step shards the batch over: the global
    one (an installed ``ProcessMesh``'s, ``fleet.init``'s or
    ``distributed.set_mesh``'s), else ``None``."""
    from ..mesh import get_mesh as _get_rank_mesh
    return _get_rank_mesh()


def _eval_batch(step, model, loss, batch):
    """One forward without gradients on this rank's rows of the global
    ``batch`` (``step``'s data shard): ``(output, loss or None)``, the
    loss averaged over the data ranks."""
    data = step._data
    xs = [step._to_device(b) for b in batch]
    if data is not None:
        xs = [data.rows(b) for b in xs]
    with torch.no_grad():
        out = model(xs[0])
        val = loss(out, xs[1]) if loss is not None and len(xs) > 1 \
            else None
    if val is not None and data is not None:
        val = data.mean(val)
    return out, val


class DistModel:
    """ref: api.py DistModel (what ``dist.to_static`` returns): the
    training step around the model (eager ``jit.TrainStep`` over the
    installed mesh; nothing is captured); in eval mode a call runs the
    forward (and the loss with a label) on this rank's rows."""

    def __init__(self, layer: torch.nn.Module, loader=None, loss=None,
                 optimizer=None, strategy=None):
        from ...jit.train_step import TrainStep
        self._layer = layer
        self._loss = loss
        self._optimizer = optimizer
        self._strategy = strategy
        self._mode = "train"
        self._step = TrainStep(layer, loss, optimizer, mesh=_step_mesh())

    def train(self):
        self._mode = "train"
        self._layer.train()

    def eval(self):
        self._mode = "eval"
        self._layer.eval()

    def __call__(self, *batch):
        if self._mode == "train":
            return self._step(*batch)
        out, val = _eval_batch(self._step, self._layer, self._loss, batch)
        return val if val is not None else out

    def state_dict(self, *a, **kw):
        return self._layer.state_dict(*a, **kw)

    def dist_main_program(self, mode=None):
        return None


def to_static(layer: torch.nn.Module, loader=None, loss=None,
              optimizer=None, strategy=None) -> DistModel:
    """ref: api.py to_static: the :class:`DistModel` of ``layer``."""
    return DistModel(layer, loader, loss, optimizer, strategy)
