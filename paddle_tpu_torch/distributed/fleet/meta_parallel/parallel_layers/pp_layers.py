"""Pipeline layer descriptions and segmentation; counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/parallel_layers/pp_layers.py``
(ref: ``fleet/meta_parallel/parallel_layers/pp_layers.py``).

The JAX package's controller builds every layer and records the stage
partition.  Here each rank is a process of its own, as in the reference:
under a pipeline degree above 1 a :class:`PipelineLayer` builds only the
layers of its stage (under ``num_virtual_pipeline_stages`` V, those of its
virtual stages ``s, s + P, ...``), and leaves ``None`` at the other
positions of ``run_function``; without a topology, or at a pipeline
degree of 1, it builds every layer (the in-process
``pp_schedules.HostPipelineSchedule`` then runs the stages).  Built
layers are registered under their global index, so a stage's parameter
names are those of the JAX package's ``PipelineLayer``.

A :class:`SharedLayerDesc` is one layer used at several positions (tied
embeddings).  In the JAX package that is object identity; here the
stages that hold it build it each, so they form a group along their
pipeline line: the first of them broadcasts its parameters when the
layer is built, and the shared weight's gradient is summed over the
group before the optimizer step: the weight carries the group as
``pp_shared_group``, which ``HybridParallelOptimizer`` reads, and
:meth:`PipelineLayer.allreduce_shared_weight_gradients` (the reference's
name) does the same sum for a loop of one's own.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Sequence

import torch

from ....communication.collective_ops import all_reduce, broadcast
from ...base.topology import get_hybrid_communicate_group

__all__ = ["LayerDesc", "SharedLayerDesc", "SegmentLayers", "PipelineLayer"]


class LayerDesc:
    """ref: ``LayerDesc`` — deferred layer construction."""

    def __init__(self, layer_func: Callable, *inputs, **kwargs):
        self.layer_func = layer_func
        self.inputs = inputs
        self.kwargs = kwargs
        if not callable(layer_func):
            raise TypeError("LayerDesc needs a Module subclass or callable")

    def build_layer(self) -> torch.nn.Module:
        return self.layer_func(*self.inputs, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({getattr(self.layer_func, '__name__', '?')})"


class SharedLayerDesc(LayerDesc):
    """ref: ``SharedLayerDesc`` — one layer at several positions, its
    ``shared_weight_attr`` parameter kept equal across the stages that
    hold it (module docstring); ``forward_func(layer, x)`` replaces the
    layer's own forward where given."""

    def __init__(self, key: str, layer_func: Callable, forward_func=None,
                 shared_weight_attr: str = "weight", *inputs, **kwargs):
        super().__init__(layer_func, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class SegmentLayers:
    """ref: ``SegmentLayers`` — split N layer descs into ``num_parts``
    contiguous stages, uniformly or at the layers whose name matches
    ``layer:<regex>``."""

    def __init__(self, layers_desc: Sequence, num_parts: int,
                 method: str = "uniform", num_virtual_pipeline_stage=None):
        self.layers_desc = layers_desc
        self.num_parts = num_parts
        self.method = method

    def do_segment(self) -> List[int]:
        n = len(self.layers_desc)
        if self.method == "uniform":
            return self.uniform(n, self.num_parts)
        if self.method.startswith("layer:"):
            name = self.method.split(":", 1)[1]

            def _matches(d):
                fn = getattr(d, "layer_func", d)
                label = getattr(fn, "__name__", type(fn).__name__)
                return re.search(name, label) is not None

            matched = [i for i, d in enumerate(self.layers_desc)
                       if _matches(d)]
            if not matched:
                return self.uniform(n, self.num_parts)
            # the matched layers split evenly; each stage starts at the
            # first matched layer of its share (stage 0 at 0)
            chunk_bounds = self.uniform(len(matched), self.num_parts)
            bounds = [0]
            for k in range(1, self.num_parts):
                bounds.append(matched[chunk_bounds[k]])
            bounds.append(n)
            return bounds
        raise ValueError(f"unknown segment method {self.method}")

    @staticmethod
    def uniform(num_items: int, num_parts: int) -> List[int]:
        result = [0] * (num_parts + 1)
        part = num_items // num_parts
        extra = num_items % num_parts
        for i in range(1, num_parts + 1):
            result[i] = result[i - 1] + part + (1 if i <= extra else 0)
        return result


class PipelineLayer(torch.nn.Module):
    """ref: ``PipelineLayer`` (module docstring).  ``loss_fn(out,
    labels)`` is the last stage's loss; ``recompute_interval`` k > 0
    recomputes every k consecutive layers of a stage in the backward
    (``fleet.recompute``, which replays the amp state);
    ``recompute_ctx`` is accepted and read by nothing, as in the JAX
    package."""

    def __init__(self, layers: Sequence, num_stages: Optional[int] = None,
                 topology=None, loss_fn=None, seg_method: str = "uniform",
                 recompute_interval: int = 0, recompute_ctx=None,
                 num_virtual_pipeline_stages: Optional[int] = None):
        super().__init__()
        self._loss_fn = loss_fn
        self._recompute_interval = recompute_interval
        self._num_virtual_pipeline_stages = num_virtual_pipeline_stages or 1

        hcg = get_hybrid_communicate_group()
        if topology is not None:
            self._topo = topology
            self._num_stages = topology.get_dim("pipe")
        elif hcg is not None:
            self._topo = hcg.topology
            self._num_stages = hcg.get_pipe_parallel_world_size()
        else:
            self._topo = None
            self._num_stages = num_stages or 1
        self._stage_id = hcg.get_stage_id() if hcg is not None else 0
        self._hcg = hcg
        self._distributed = hcg is not None and \
            hcg.get_pipe_parallel_world_size() > 1

        self._layers_desc = list(layers)
        seg = SegmentLayers(self._layers_desc, self._num_stages, seg_method)
        self.segment_parts = seg.do_segment()
        n = len(self._layers_desc)
        own = self._own_positions()

        self._shared_layers: Dict[str, torch.nn.Module] = {}
        self._shared_weight_attrs: Dict[str, str] = {}
        self.run_function: List[Optional[torch.nn.Module]] = [None] * n
        for i, d in enumerate(self._layers_desc):
            if i not in own:
                continue
            if isinstance(d, SharedLayerDesc):
                if d.layer_name not in self._shared_layers:
                    self._shared_layers[d.layer_name] = d.build_layer()
                    self._shared_weight_attrs[d.layer_name] = \
                        d.shared_weight_attr
                layer = _SharedCall(self._shared_layers[d.layer_name],
                                    d.forward_func)
            elif isinstance(d, LayerDesc):
                layer = d.build_layer()
            elif isinstance(d, torch.nn.Module):
                layer = d
            elif callable(d):
                layer = _FnLayer(d)
            else:
                raise TypeError(f"cannot build pipeline item {d!r}")
            self.run_function[i] = layer
            self.add_module(str(i), layer)
        self._shared_groups = self._build_shared_groups()

    # -- which positions this process builds ------------------------------
    def virtual_stage_bounds(self, n_virtual: int):
        """Each of ``n_virtual`` virtual stages' ``(start, end)`` in the
        layer list (the JAX package's ``pp_schedules._virtual_bounds``):
        the segmentation's stages at one virtual stage a stage, else
        uniform contiguous slices (virtual stage k runs on stage k % P,
        as Megatron's interleaved schedule places them)."""
        if n_virtual == self._num_stages:
            return [self.stage_bounds(s) for s in range(n_virtual)]
        base, rem = divmod(len(self._layers_desc), n_virtual)
        bounds, start = [], 0
        for k in range(n_virtual):
            size = base + (1 if k < rem else 0)
            bounds.append((start, start + size))
            start += size
        return bounds

    def local_virtual_stages(self) -> List[int]:
        """The virtual stages this rank runs: its stage, or under V
        virtual stages a stage ``s, s + P, ..., s + (V - 1) P``."""
        p, v = self._num_stages, self._num_virtual_pipeline_stages
        return [k for k in range(p * v) if k % p == self._stage_id]

    def _own_positions(self):
        n = len(self._layers_desc)
        if not self._distributed:
            return set(range(n))
        p, v = self._num_stages, self._num_virtual_pipeline_stages
        bounds = self.virtual_stage_bounds(p * v)
        return {i for k in self.local_virtual_stages()
                for i in range(*bounds[k])}

    def _build_shared_groups(self):
        """The group of each shared layer's stages along every pipeline
        line (a collective call when distributed), and the first stage's
        parameters broadcast to the others."""
        out = {}
        if not self._distributed:
            return out
        from ....communication.group import _make_group
        p, v = self._num_stages, self._num_virtual_pipeline_stages
        bounds = self.virtual_stage_bounds(p * v)
        keys = []
        for d in self._layers_desc:
            if isinstance(d, SharedLayerDesc) and d.layer_name not in keys:
                keys.append(d.layer_name)
        hcg = self._hcg
        for key in keys:
            stages = sorted({k % p for k in range(p * v)
                             for i in range(*bounds[k])
                             if isinstance(self._layers_desc[i],
                                           SharedLayerDesc)
                             and self._layers_desc[i].layer_name == key})
            if len(stages) < 2:
                continue
            mine = None
            for line in hcg.mesh.comm_lists("pp"):
                line = sorted(line,
                              key=lambda r: hcg.topology.get_coord(r).pipe)
                g = _make_group([line[s] for s in stages],
                                name=f"pp_shared_{key}")
                if hcg.get_global_rank() in g.ranks:
                    mine = g
            if mine is not None and self._stage_id in stages:
                src = hcg.get_rank_from_stage(stages[0])
                with torch.no_grad():
                    for t in list(self._shared_layers[key].parameters()) + \
                            list(self._shared_layers[key].buffers()):
                        buf = t.data.contiguous()
                        broadcast(buf, src=src, group=mine)
                        if buf is not t.data:
                            t.data.copy_(buf)
                # the hybrid optimizer sums it over the group
                getattr(self._shared_layers[key],
                        self._shared_weight_attrs[key]).pp_shared_group = mine
                out[key] = mine
        return out

    def allreduce_shared_weight_gradients(self) -> None:
        """ref: ``allreduce_shared_weight_gradients``: each shared
        layer's weight gradient summed over the stages that hold it."""
        for key, group in self._shared_groups.items():
            w = getattr(self._shared_layers[key],
                        self._shared_weight_attrs[key])
            if w.grad is not None:
                all_reduce(w.grad, group=group)

    def shared_weights(self) -> List[torch.nn.Parameter]:
        """The shared weights whose gradients
        :meth:`allreduce_shared_weight_gradients` sums."""
        return [getattr(self._shared_layers[k], self._shared_weight_attrs[k])
                for k in self._shared_groups]

    # -- stage access (the schedules) --------------------------------------
    def get_num_stages(self) -> int:
        return self._num_stages

    def get_num_virtual_stages(self) -> int:
        return self._num_virtual_pipeline_stages

    def get_stage_id(self) -> int:
        return self._stage_id

    def stage_bounds(self, stage_id: int):
        return self.segment_parts[stage_id], self.segment_parts[stage_id + 1]

    def layers_of(self, start: int, end: int) -> List[torch.nn.Module]:
        """The layers ``[start, end)``; raises if this process does not
        hold one of them (a stage never runs another stage's layer)."""
        out = self.run_function[start:end]
        if any(layer is None for layer in out):
            raise RuntimeError(
                f"layers [{start}, {end}) are not all on stage "
                f"{self._stage_id}: a stage runs its own layers only")
        return out

    def stage_layers(self, stage_id: int) -> List[torch.nn.Module]:
        return self.layers_of(*self.stage_bounds(stage_id))

    def get_stage_from_index(self, layer_idx: int) -> int:
        for s in range(self._num_stages):
            if self.segment_parts[s] <= layer_idx < self.segment_parts[s + 1]:
                return s
        return self._num_stages - 1

    def forward(self, input, chunk_id=None):
        """Every layer in order when this process holds them all; under
        a pipeline degree above 1 the rank's stage (``chunk_id``: its
        ``chunk_id``-th virtual stage)."""
        if self._distributed:
            k = self.local_virtual_stages()[chunk_id or 0]
            p, v = self._num_stages, self._num_virtual_pipeline_stages
            layers = self.layers_of(*self.virtual_stage_bounds(p * v)[k])
        else:
            layers = self.run_function
        x = input
        for i, fn in enumerate(layers):
            if self._recompute_interval > 0 and \
                    i % self._recompute_interval == 0 and self.training:
                from ...recompute import recompute
                x = recompute(fn, *x) if isinstance(x, tuple) \
                    else recompute(fn, x)
            else:
                x = fn(*x) if isinstance(x, tuple) else fn(x)
        return x


class _FnLayer(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self._fn = fn

    def forward(self, *x):
        return self._fn(*x)


class _SharedCall(torch.nn.Module):
    def __init__(self, shared: torch.nn.Module, forward_func=None):
        super().__init__()
        self._shared = shared
        self._forward_func = forward_func

    def forward(self, *x):
        if self._forward_func is not None:
            return self._forward_func(self._shared, *x)
        return self._shared(*x)
