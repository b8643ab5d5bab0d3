"""The pipeline training steps of homogeneous-block transformers;
counterpart of ``paddle_tpu/distributed/fleet/meta_parallel/pp_spmd.py``
(ref: ``fleet/meta_parallel/pipeline_parallel.py`` and
``pp_utils/p2p_communication.py``).

The JAX package stacks the L blocks' parameters on a leading axis sharded
over ``pp`` and runs a compiled ring of ``ppermute`` hops.  Here each rank
is a process that holds its own blocks, so no stacking is needed: rank r
of P keeps the blocks of virtual stages ``r, r + P, ..., r + (V - 1) P``
(``n_chunks`` V; virtual stage k holds blocks ``[k L / PV, (k + 1) L /
PV)``), the model's other blocks are replaced by placeholders that raise
if called, and the rank registers with the optimizer its blocks and the
replicated tails (embeddings, final norm, head), of which it updates
those it used (a parameter without a gradient is not stepped).  The step
is the 1F1B schedule (VPP when V > 1) of ``pp_schedules`` over the
topology's p2p channels: ``pre_fn`` (the embedding) on the first virtual
stage, the blocks, ``post_fn`` (final norm, head, fp32 cross entropy) on
the last.  ``remat_blocks`` recomputes each block in the backward
(``fleet.recompute``, replaying the amp state and the blocks' dropout
generators).  A weight both ends use (GPT's head tied to the word
embedding) is summed over the first and last stage before the step
(``pp_shared_group``).  Gradients are averaged over the ``dp_axes``
ranks, whose rows of each micro-batch are theirs, once a step; mp layers
inside a stage split as they do without pipelines.  ``sync_fn`` has
nothing to write back: the blocks are the model's own.  A ``scaler``
(``amp.GradScaler``) scales each micro-batch's loss on the last stage;
its ``step`` and ``update`` run once, after the gradient reductions, its
flag reduced over every rank; ``autocast`` (a
zero-argument context-manager factory, e.g. ``functools.partial(
amp.auto_cast, level="O2", dtype="bfloat16")``) is entered around every
forward.
"""
from __future__ import annotations

import contextlib
from typing import Callable, List, Optional

import torch

from ...communication.collective_ops import all_reduce, broadcast
from ...communication.group import ReduceOp
from ..recompute import recompute
from .pp_schedules import P2PPipelineSchedule, _StageRunner

__all__ = ["PipelineSpmdStep", "make_transformer_pipeline_step",
           "gpt_pipeline_step"]


def _generators_of(module: torch.nn.Module):
    """Every ``torch.Generator`` the module's layers draw dropout from."""
    out = []
    for m in module.modules():
        g = getattr(m, "gen", None)
        if isinstance(g, torch.Generator) and all(g is not o for o in out):
            out.append(g)
    return tuple(out) or None


class _NotOnThisStage(torch.nn.Module):
    """The place of a block that another pipeline rank holds."""

    def __init__(self, index: int):
        super().__init__()
        self.index = index

    def forward(self, *args, **kwargs):
        raise RuntimeError(f"block {self.index} is on another pipeline "
                           "stage: a stage runs its own blocks only")


class _Call(torch.nn.Module):
    """One piece of a stage: ``fn(*args, h)`` under the step's autocast,
    recomputed in the backward when asked."""

    def __init__(self, fn, args, autocast, remat=False, module=None):
        super().__init__()
        self._fn, self._args, self._autocast = fn, args, autocast
        self._remat = remat
        self.block = module            # registers the block's parameters
        self._gens = _generators_of(module) if module is not None else None

    def _run(self, h):
        with (self._autocast() if self._autocast is not None
              else contextlib.nullcontext()):
            return self._fn(*self._args, h)

    def forward(self, h):
        if self._remat:
            return recompute(self._run, h, generator=self._gens)
        return self._run(h)


class PipelineSpmdStep:
    """A pipeline (+dp, +mp inside a stage) train step over this rank's
    blocks (module docstring).  ``block_param_stacks`` stands where the
    JAX package's stacks stood: the rank's own blocks, virtual stage by
    virtual stage, each ``block_fn(block, h)``; ``pre_fn(rep_params,
    ids)`` and ``post_fn(rep_params, h, labels)`` as there.  ``mesh`` is
    the fleet topology's mesh (``hcg.mesh``); ``__call__(inputs,
    labels)`` takes the global batch and returns the mean loss on every
    rank."""

    def __init__(self, pre_fn, block_fn, post_fn, rep_params: List,
                 block_param_stacks: List, optimizer, mesh,
                 n_micro: int, axis_name: str = "pp", dp_axes=("dp",),
                 remat_blocks: bool = True, sync_fn: Optional[Callable] = None,
                 n_chunks: int = 1, scaler=None, autocast=None):
        self.scaler = scaler if (scaler is not None
                                 and scaler.is_enable()) else None
        if axis_name != "pp":
            raise ValueError(f"axis_name {axis_name!r}: the fleet mesh's "
                             "pipeline axis is 'pp'")
        from ..base.topology import get_hybrid_communicate_group
        self.hcg = get_hybrid_communicate_group()
        if self.hcg is None or self.hcg.mesh is not mesh:
            raise ValueError("mesh must be the fleet topology's "
                             "(fleet.init, then hcg.mesh)")
        self.pre_fn, self.block_fn, self.post_fn = pre_fn, block_fn, post_fn
        self.rep_params = list(rep_params)
        self.block_stacks = list(block_param_stacks)
        self.sync_fn = sync_fn
        self.optimizer = getattr(optimizer, "_inner_opt", optimizer)
        self.mesh = mesh
        self.n_micro = int(n_micro)
        self.dp_axes = tuple(a for a in dp_axes if mesh.shape.get(a, 1) > 1)
        self.n_chunks = int(n_chunks)
        self.autocast = autocast
        h = self.hcg
        p = h.get_pipe_parallel_world_size()
        self.n_virtual = p * self.n_chunks
        lv = len(self.block_stacks) // self.n_chunks
        ks = [k for k in range(self.n_virtual)
              if k % p == h.get_stage_id()]
        runners = {}
        for c, k in enumerate(ks):
            layers = []
            if k == 0:
                layers.append(_Call(pre_fn, (self.rep_params,), autocast))
            for blk in self.block_stacks[c * lv:(c + 1) * lv]:
                layers.append(_Call(block_fn, (blk,), autocast,
                                    remat=remat_blocks, module=blk))
            runners[k] = _StageRunner(
                layers, loss_fn=self._post if k == self.n_virtual - 1
                else None)
        dev = next(iter(self.params())).device
        self.sched = P2PPipelineSchedule(
            schedule_mode="VPP" if self.n_chunks > 1 else "1F1B", hcg=h,
            n_stages=p, n_virtual=self.n_virtual, runners=runners,
            device=dev)
        self.device = dev

    def _post(self, h, labels):
        with (self.autocast() if self.autocast is not None
              else contextlib.nullcontext()):
            return self.post_fn(self.rep_params, h, labels)

    def params(self) -> List[torch.nn.Parameter]:
        """The rank's blocks' parameters, then the tails'."""
        seen, out = set(), []
        for t in [q for b in self.block_stacks for q in b.parameters()] + \
                self.rep_params:
            if id(t) not in seen:
                seen.add(id(t))
                out.append(t)
        return out

    def _rows(self, t: torch.Tensor) -> List[torch.Tensor]:
        """The micro-batches of ``t`` (the global batch), each this rank's
        rows along the dp axes."""
        t = torch.as_tensor(t).to(self.device)
        m = self.n_micro
        b = t.shape[0]
        if b % m:
            raise ValueError(f"batch {b} not divisible by {m} microbatches")
        micro = t.reshape((m, b // m) + tuple(t.shape[1:]))
        if not self.dp_axes:
            return list(micro)
        g = self.mesh.group(self.dp_axes)
        if micro.shape[1] % g.nranks:
            raise ValueError(f"micro-batch {micro.shape[1]} rows do not "
                             f"split over {g.nranks} data ranks")
        k = micro.shape[1] // g.nranks
        return list(micro[:, g.rank * k:(g.rank + 1) * k])

    def __call__(self, inputs, labels):
        from ..utils.hybrid_parallel_util import (
            fused_allreduce_gradients_with_group, pipeline_allreduce_gradients)
        xs, ys = self._rows(inputs), self._rows(labels)
        scaler = self.scaler
        self.sched.loss_scale = None if scaler is None \
            else scaler._on(self.device)
        loss = self.sched.forward_backward(xs, ys)
        params = self.params()
        pipeline_allreduce_gradients(params, None)     # the tied weights
        if self.dp_axes:
            fused_allreduce_gradients_with_group(
                [q for q in params if q.grad is not None],
                self.mesh.group(self.dp_axes))
        if scaler is not None:
            scaler.step(self.optimizer)
            scaler.update()
        else:
            self.optimizer.step()
        self.optimizer.clear_grad()
        if self.sync_fn is not None:
            self.sync_fn()
        return self._broadcast_loss(loss)

    def _broadcast_loss(self, loss):
        h = self.hcg
        last = (self.n_virtual - 1) in self.sched.runners
        buf = torch.zeros(1, dtype=torch.float32, device=self.device)
        if last:
            buf[0] = loss.float()
            if self.dp_axes:
                all_reduce(buf, op=ReduceOp.AVG,
                           group=self.mesh.group(self.dp_axes))
        broadcast(buf, src=h.get_rank_from_stage(
            h.get_pipe_parallel_world_size() - 1),
            group=h.get_pipe_parallel_group())
        return buf[0]


def _tie_across_stages(weights, hcg) -> None:
    """Each weight of ``weights`` (used by the first and the last stage)
    made equal across them and marked for the gradient sum over them
    (``pp_shared_group``); every rank makes the groups."""
    p = hcg.get_pipe_parallel_world_size()
    if p == 1:
        return
    from ...communication.group import _make_group
    mine = None
    for line in hcg.mesh.comm_lists("pp"):
        line = sorted(line, key=lambda r: hcg.topology.get_coord(r).pipe)
        g = _make_group([line[0], line[-1]], name="pp_tied")
        if hcg.get_global_rank() in g.ranks:
            mine = g
    if mine is None:
        return
    with torch.no_grad():
        for w in weights:
            buf = w.data.contiguous()
            broadcast(buf, src=mine.ranks[0], group=mine)
            if buf is not w.data:
                w.data.copy_(buf)
            w.pp_shared_group = mine


def make_transformer_pipeline_step(blocks, rep_tensors, pre_fn, post_fn,
                                   optimizer, mesh, n_micro: int,
                                   axis_name: str = "pp",
                                   dp_axes=("dp", "sharding"),
                                   remat_blocks: bool = True,
                                   n_chunks: int = 1,
                                   stack_prefix: str = "pp_stack",
                                   scaler=None, autocast=None):
    """Shared by the model adapters (GPT, LLaMA): ``blocks``
    is the model's block list (an ``nn.ModuleList``, homogeneous; L must
    divide by P x ``n_chunks``).  The rank keeps its blocks, puts
    placeholders at the others, and hands the optimizer its blocks'
    parameters and ``rep_tensors`` (module docstring); ``stack_prefix``
    names nothing here (there are no stacks)."""
    from ..base.topology import get_hybrid_communicate_group
    hcg = get_hybrid_communicate_group()
    n_blocks = len(blocks)
    n_stage = int(mesh.shape[axis_name])
    vv = int(n_chunks)
    if n_blocks % (n_stage * vv):
        raise ValueError(
            f"num_layers {n_blocks} must divide pp_degree*n_chunks "
            f"{n_stage * vv}")
    lv = n_blocks // (n_stage * vv)
    r = hcg.get_stage_id()
    own = [(k * n_stage + r) * lv + j for k in range(vv) for j in range(lv)]
    for i in range(n_blocks):
        if i not in own:
            blocks[i] = _NotOnThisStage(i)
    local = [blocks[i] for i in own]

    def block_fn(block, h):
        return block(h)

    opt = getattr(optimizer, "_inner_opt", optimizer)
    seen, mine = set(), []
    for t in [q for b in local for q in b.parameters()] + list(rep_tensors):
        if id(t) not in seen:
            seen.add(id(t))
            mine.append(t)
    opt.param_groups[0]["params"] = mine
    for q in list(opt.state):
        if id(q) not in seen:
            del opt.state[q]
    return PipelineSpmdStep(pre_fn, block_fn, post_fn, list(rep_tensors),
                            local, opt, mesh, n_micro,
                            axis_name=axis_name, dp_axes=dp_axes,
                            remat_blocks=remat_blocks, sync_fn=None,
                            n_chunks=n_chunks, scaler=scaler,
                            autocast=autocast)


def fp32_cross_entropy(logits, labels, ignore_index: int = -100):
    """The pipeline steps' loss: per-token cross entropy of fp32 logits
    (split over mp: ``ParallelCrossEntropy``), masked mean over the
    tokens that are not ``ignore_index``, in fp32."""
    from .parallel_layers.mp_layers import ParallelCrossEntropy
    b, s, v = logits.shape
    flat = labels.reshape(b * s)
    loss = ParallelCrossEntropy(ignore_index=ignore_index)(
        logits.float().reshape(b * s, v), flat)
    mask = (flat != ignore_index).float()
    return (loss.float() * mask).sum() / mask.sum().clamp(min=1.0)


def gpt_pipeline_step(model, optimizer, mesh, n_micro: int,
                      axis_name: str = "pp", dp_axes=("dp", "sharding"),
                      remat_blocks: bool = True, n_chunks: int = 1,
                      scaler=None, autocast=None) -> PipelineSpmdStep:
    """The pipeline step of a ``GPTForPretraining`` built under the fleet
    topology: pre = the word and position embeddings (no dropout, as the
    JAX package's), blocks = the L ``GPTBlock``\\ s, post = a plain
    LayerNorm in fp32, the head tied to the word embedding (held by the
    first and the last stage, its gradient summed over them) and fp32
    cross entropy."""
    from ..base.topology import get_hybrid_communicate_group
    gpt = model.gpt
    emb = gpt.embeddings
    emb_w = emb.word_embeddings.weight
    pos_w = emb.position_embeddings.weight
    ln_w, ln_b = gpt.final_ln.weight, gpt.final_ln.bias
    rep_tensors = [emb_w, pos_w, ln_w, ln_b]
    pc = model._pc

    def pre_fn(rep_v, ids):
        pos = torch.arange(ids.shape[-1], device=ids.device)
        return emb.word_embeddings(ids) + emb.position_embeddings(pos)

    def post_fn(rep_v, h, labels):
        w, _, lw, lb = rep_v
        hf = h.float()
        mu = hf.mean(-1, keepdim=True)
        var = hf.var(-1, unbiased=False, keepdim=True)
        hn = (hf - mu) * torch.rsqrt(var + 1e-5) * lw + lb
        return fp32_cross_entropy(pc.head(hn, w), labels)

    step = make_transformer_pipeline_step(
        gpt.layers, rep_tensors, pre_fn, post_fn, optimizer, mesh, n_micro,
        axis_name=axis_name, dp_axes=dp_axes, remat_blocks=remat_blocks,
        n_chunks=n_chunks, stack_prefix="pp_block_stack", scaler=scaler,
        autocast=autocast)
    _tie_across_stages([emb_w], get_hybrid_communicate_group())
    return step
