"""Mixture-of-Experts layer with expert parallelism; counterpart of
``paddle_tpu/incubate/distributed/models/moe/moe_layer.py`` (ref:
``python/paddle/incubate/distributed/models/moe/moe_layer.py`` and the
gates of ``moe/gate/``).

The JAX package is one controller: ``T`` is the global token count, the
queue positions are a cumsum over the global batch in dp-rank-major
order, and GSPMD places the collectives.  Here each process holds its
dp rank's tokens and places them itself:

* **routing** (:func:`route`): the fp32 softmax of the gate logits, the
  top-k (ties to the lower expert, as ``jax.lax.top_k``), renormalised
  over ``max(sum, 1e-9)``; each (token, choice) takes the next place in
  its expert's queue, token-major (a token's k choices are consecutive),
  and is kept when the place is under ``cap = max(ceil(k * T / E *
  capacity_factor), 1)``;
* **global capacity**: ``T`` is the data group's (dp x sharding) token
  count, and a dp rank adds to its places the count of choices earlier
  dp ranks gave each expert (an all-gather of ``[E]`` counts), so the
  tokens that overflow are the ones the JAX package drops;
* **expert parallelism**: the ranks of an ep group see the same tokens;
  each holds ``E / ep`` experts (global indices ``ep_rank * E / ep`` on)
  and computes their queues.  The input passes ``_c_identity`` (its
  gradient summed over ep) and the combined output ``_mp_allreduce``
  (summed over ep, in fp32), as do the combine weights (their gradient
  summed over ep): Megatron's column / row pair over the expert
  dimension, ``fleet.meta_parallel.parallel_layers.mp_ops`` on the ep
  group.  Every dense gradient is then the same on every rank of an ep
  group;
* **dispatch and combine** by index: each kept (token, choice) writes
  its token to slot ``(e - lo) * cap + place`` of ``[E / ep, cap, M]``
  and reads its expert's output back from there, weighted; the JAX
  package's one-hot ``[T, E, C]`` einsums compute the same (a slot holds
  one token with weight 1; a token's combine has k terms) and stay here
  as :meth:`MoELayer.forward_einsum`, the oracle the tests hold the
  index form against;
* **the aux loss is global**: ``GShardGate`` / ``SwitchGate`` take
  ``E * sum(mean_t(probs) * mean_t(onehot(argmax)))`` over the data
  group's tokens, the sums all-reduced before the product (the mean
  probabilities with a gradient that every dp rank's backward carries,
  so the dp average of the gradients is the global one).

The experts run stacked (``torch.func.vmap`` of the first local expert
over the stacked parameters, the JAX package's vmap) when they are
alike, else one by one with the JAX package's ``RuntimeWarning``.
Under O2 the dispatched rows are cast to the low dtype (the JAX einsum's
cast), the combine weights to the experts' output dtype, and the
combine sums in fp32.  ``moe_group`` (default: the fleet topology's ep
group), ``mp_group`` and ``recompute_interval`` are accepted as the JAX
package accepts them; an MoE layer under mp, pp, sharding, sep or cp
raises ``NotImplementedError``, as does ``E % ep != 0``.
"""
from __future__ import annotations

import math
import warnings
from typing import Optional, Sequence

import torch
from torch import nn

from ..... import amp
from .....device import default_device
from .....distributed.fleet.base.topology import (
    get_hybrid_communicate_group)
from .....distributed.fleet.meta_parallel.parallel_layers.mp_ops import (
    _c_identity, _gather, _mp_allreduce)
from .....nn import functional as F
from .....nn.clip import ClipGradByGlobalNorm, _sq_sum
from .....nn.layers import Linear

__all__ = ["BaseGate", "NaiveGate", "GShardGate", "SwitchGate", "GATES",
           "MoELayer", "ClipGradForMOEByGlobalNorm", "route",
           "dispatch_masks", "token_group", "global_sum", "group_sum",
           "is_expert_param"]


def token_group():
    """The group the batch is split over (the fleet topology's dp x
    sharding group), or None at one rank of it."""
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        return None
    g = hcg.get_dp_sharding_parallel_group()
    return g if g is not None and g.nranks > 1 else None


def global_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group``; its backward sums the gradients over
    the group as well: every rank holds the same global value, so each
    rank's backward carries the whole gradient of its own share, which
    the dp average of the parameters' gradients turns into the global
    one."""
    if group is None:
        return t
    return _mp_allreduce(_c_identity(t, group), group)


def group_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group`` (no gradient)."""
    if group is None:
        return t
    from .....distributed.communication.collective_ops import all_reduce
    t = t.clone()
    all_reduce(t, group=group)
    return t


def is_expert_param(p) -> bool:
    """Whether ``p`` belongs to an MoE layer's expert (``MoELayer`` sets
    ``expert_index``, the expert's global index)."""
    return getattr(p, "expert_index", None) is not None


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------

def _aux_loss(probs, logits, n_expert: int, group):
    """``E * sum(mean_t(probs) * mean_t(onehot(argmax(logits))))`` over
    the data group's tokens, with the JAX ops' amp casts."""
    t_global = probs.shape[0] * (group.nranks if group is not None else 1)
    me = global_sum(probs.sum(0), group) / t_global
    top1 = torch.argmax(logits, dim=-1)
    ce = group_sum(torch.nn.functional.one_hot(top1, n_expert).float()
                    .sum(0), group) / t_global
    me, ce = amp.cast("multiply", me, ce)
    (prod,) = amp.cast("sum", me * ce)
    (total,) = amp.cast("scale", prod.sum())
    return total * float(n_expert)


class BaseGate(nn.Module):
    def __init__(self, d_model: int, num_expert: int, world_size: int = 1,
                 top_k: int = 2):
        super().__init__()
        self.d_model = d_model
        self.num_expert = num_expert
        self.world_size = world_size
        self.tot_expert = num_expert * world_size
        self.top_k = top_k
        self.loss = None

    def get_loss(self):
        return self.loss


class NaiveGate(BaseGate):
    """ref: ``moe/gate/naive_gate.py`` — a plain linear router, no aux
    loss.  ``generator`` / ``device`` draw the router's weight."""

    def __init__(self, d_model, num_expert, world_size=1, top_k=2, *,
                 generator=None, device=None):
        super().__init__(d_model, num_expert, world_size, top_k)
        self.gate = Linear(d_model, self.tot_expert, generator=generator,
                           device=device)

    def forward(self, x):
        return self.gate(x), None


class GShardGate(BaseGate):
    """ref: ``moe/gate/gshard_gate.py`` — top-2 with the load-balancing
    aux loss over the global batch.  ``capacity[0]`` is kept as
    ``capacity_factor``; ``group`` is accepted as the JAX package
    accepts it."""

    def __init__(self, d_model, num_expert, world_size=1, top_k=2,
                 capacity=(1.2, 2.4), group=None, *, generator=None,
                 device=None):
        super().__init__(d_model, num_expert, world_size, top_k)
        self.gate = Linear(d_model, self.tot_expert, generator=generator,
                           device=device)
        self.capacity_factor = capacity[0]

    def forward(self, x):
        logits = self.gate(x)
        probs = F.softmax(logits, axis=-1)
        self.loss = _aux_loss(probs, logits, self.tot_expert, token_group())
        return logits, self.loss


class SwitchGate(BaseGate):
    """ref: ``moe/gate/switch_gate.py`` — top-1 routing and the switch
    aux loss; in training with ``switch_eps`` the logits are scaled by
    ``1 + eps * U(-1, 1)`` noise drawn from ``generator``."""

    def __init__(self, d_model, num_expert, world_size=1, top_k=1,
                 switch_eps: float = 0.1, capacity=(1.2, 2.4), group=None,
                 *, generator=None, device=None):
        super().__init__(d_model, num_expert, world_size, top_k=1)
        self.gate = Linear(d_model, self.tot_expert, generator=generator,
                           device=device)
        self.switch_eps = switch_eps
        self._gen = generator

    def forward(self, x):
        logits = self.gate(x)
        if self.training and self.switch_eps:
            noise = torch.rand(logits.shape, generator=self._gen,
                               device=logits.device) * 2.0 - 1.0
            logits, scale = amp.cast("multiply", logits,
                                     1.0 + noise * self.switch_eps)
            logits = logits * scale
        probs = F.softmax(logits, axis=-1)
        self.loss = _aux_loss(probs, logits, self.tot_expert, token_group())
        return logits, self.loss


GATES = {"naive": NaiveGate, "gshard": GShardGate, "switch": SwitchGate}


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def route(logits: torch.Tensor, top_k: int, cap: int, group=None):
    """The plan of every (token, choice): ``(weights, experts, places,
    keep)``, each ``[T, k]``.  ``weights`` are the renormalised top-k
    probabilities (fp32, differentiable), ``places`` the positions in the
    experts' queues over the data ``group``'s batch (this rank's tokens
    after the earlier ranks'), ``keep`` whether a place is under
    ``cap``."""
    t, e = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)[1]
    experts = order[:, :top_k]
    weights = probs.gather(1, experts)
    weights = weights / weights.sum(-1, keepdim=True).clamp(min=1e-9)
    flat = torch.nn.functional.one_hot(experts.reshape(-1), e)  # [T*k, E]
    cum = flat.cumsum(0)
    places = (cum * flat).sum(-1).view(t, top_k) - 1
    if group is not None:
        counts = _gather(cum[-1].unsqueeze(0).contiguous(), 0, group)
        offset = counts[:group.rank].sum(0)
        places = places + offset[experts]
    return weights, experts, places, places < cap


def dispatch_masks(weights, experts, places, keep, n_expert: int, cap: int):
    """The JAX package's one-hot ``disp`` and ``comb`` ``[T, E, C]`` from
    a plan (fp32; ``comb`` carries the weights' gradient)."""
    onehot = torch.nn.functional.one_hot(experts, n_expert).float()
    slot = torch.nn.functional.one_hot(places.clamp(0, cap - 1), cap)
    capslot = slot.unsqueeze(2).float() * onehot.unsqueeze(-1)  # [T,k,E,C]
    disp = (capslot * keep[..., None, None]).sum(1)
    comb = (capslot * keep[..., None, None]
            * weights[..., None, None]).sum(1)
    return disp, comb


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

class _ExpertList(nn.Module):
    """This rank's experts under their global indices (the state-dict
    names are ``experts.{e}...`` at any ep); indexed by global index,
    iterated in order."""

    def __init__(self, experts):
        super().__init__()
        for e, m in experts:
            self.add_module(str(e), m)

    def __getitem__(self, e):
        return self._modules[str(e)]

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self):
        return len(self._modules)

    def indices(self):
        return [int(k) for k in self._modules]


def _hashable(v):
    if isinstance(v, (int, float, bool, str)):
        return v
    if isinstance(v, (tuple, list)) and all(
            isinstance(i, (int, float, bool, str)) for i in v):
        return tuple(v)
    return None


def _structure(e):
    sig = []
    for m in e.modules():
        attrs = tuple(sorted(
            (k, _hashable(v)) for k, v in vars(m).items()
            if not k.startswith("_") and _hashable(v) is not None))
        sig.append((type(m).__name__, attrs))
    return tuple(sig)


class MoELayer(nn.Module):
    """ref: ``moe_layer.py`` MoELayer, the reference's parameters in its
    order.  ``experts``: every expert (``E`` of them; each maps ``[..,
    d_model]`` to ``[.., d_model]``); under an ep group this rank keeps
    its ``E / ep`` (the others may be built on the ``meta`` device).
    ``gate``: ``dict(type='gshard'|'switch'|'naive', top_k=...)`` or a
    ``BaseGate``.  ``generator`` / ``device`` draw a gate built from a
    dict (default device: the experts').  After a forward, ``dropped``
    counts this rank's (token, choice) pairs over capacity (a device
    scalar)."""

    def __init__(self, d_model: int, experts: Sequence[nn.Module],
                 gate=None, moe_group=None, mp_group=None,
                 recompute_interval: int = 0,
                 capacity_factor: float = 1.25, *, generator=None,
                 device=None, **kwargs):
        super().__init__()
        hcg = get_hybrid_communicate_group()
        if hcg is not None:
            for what, n in (
                    ("mp", hcg.get_model_parallel_world_size()),
                    ("pp", hcg.get_pipe_parallel_world_size()),
                    ("sharding", hcg.get_sharding_parallel_world_size()),
                    ("sep", hcg.get_sep_parallel_world_size()),
                    ("cp", hcg.get_context_parallel_world_size())):
                if n > 1:
                    raise NotImplementedError(
                        f"MoELayer under {what} degree {n} waits for a "
                        "later slice of MoE")
        if moe_group is None and hcg is not None:
            moe_group = hcg.get_expert_parallel_group()
        self._ep_group = moe_group if moe_group is not None and \
            moe_group.nranks > 1 else None
        self.d_model = d_model
        experts = list(experts)
        self.num_expert = len(experts)
        ep = self._ep_group.nranks if self._ep_group is not None else 1
        if self.num_expert % ep:
            raise NotImplementedError(
                f"{self.num_expert} experts over an expert degree of {ep}: "
                "uneven expert placement waits for a later slice")
        rank = self._ep_group.rank if self._ep_group is not None else 0
        per = self.num_expert // ep
        self._lo, self._hi = rank * per, (rank + 1) * per
        self.capacity_factor = capacity_factor
        self.recompute_interval = recompute_interval
        self.dropped = None
        local = [(e, experts[e]) for e in range(self._lo, self._hi)]
        if device is None:
            p0 = next((p for _, m in local for p in m.parameters()), None)
            device = p0.device if p0 is not None else None
        self.experts = _ExpertList(local)
        for e, m in local:
            for p in m.parameters():
                p.expert_index = e
        if gate is None:
            gate = {"type": "gshard", "top_k": 2}
        if isinstance(gate, dict):
            cls = GATES[gate.get("type", "gshard")]
            self.top_k = int(gate.get("top_k", 2 if gate.get("type") !=
                                      "switch" else 1))
            self.gate = cls(d_model, self.num_expert, top_k=self.top_k,
                            generator=generator, device=device)
        else:
            self.gate = gate
            self.top_k = gate.top_k
        # the structure is fixed at construction: decide stacked vs loop
        # once (over every expert, as the JAX package does)
        self._experts_stackable = self._check_stackable(experts)
        self._experts_stochastic = any(
            "Dropout" in type(m).__name__
            for e in experts for m in e.modules())

    @staticmethod
    def _check_stackable(experts) -> bool:
        """True iff one expert vmapped over the stacked parameters computes
        every expert: the same sublayer types and scalar attributes, the
        same parameter shapes and dtypes, and no buffers."""
        if not experts:
            return False
        plists = [list(e.parameters()) for e in experts]
        n = len(plists[0])
        sig0 = _structure(experts[0])
        if n == 0 or any(_structure(e) != sig0 for e in experts):
            return False
        if any(len(pl) != n for pl in plists):
            return False
        if any(pl[i].shape != plists[0][i].shape
               or pl[i].dtype != plists[0][i].dtype
               for pl in plists for i in range(n)):
            return False
        return not any(len(list(e.buffers())) > 0 for e in experts)

    def _capacity(self, t_local: int, group) -> int:
        t = t_local * (group.nranks if group is not None else 1)
        e, k = self.num_expert, self.top_k
        return max(int(math.ceil(k * t / e * self.capacity_factor)), 1)

    def _plan(self, xf):
        group = token_group()
        cap = self._capacity(xf.shape[0], group)
        logits, _ = self.gate(xf)
        return route(logits, self.top_k, cap, group) + (cap,)

    def forward(self, x):
        orig_shape = x.shape
        d = orig_shape[-1]
        xf = x.reshape(-1, d)
        t, k = xf.shape[0], self.top_k
        weights, experts, places, keep, cap = self._plan(xf)
        # (token, choice) pairs of this rank over capacity (a device count)
        self.dropped = (~keep).sum()
        n_local = self._hi - self._lo
        valid = keep & (experts >= self._lo) & (experts < self._hi)
        slot = torch.where(valid, (experts - self._lo) * cap + places,
                           torch.full_like(places, n_local * cap))
        slot = slot.reshape(-1)
        # dispatch: the einsum's cast, then the tokens into their slots
        (xd,) = amp.cast("einsum", xf)
        if self._ep_group is not None:
            xd = _c_identity(xd, self._ep_group)
        rows = xd.unsqueeze(1).expand(t, k, d).reshape(t * k, d)
        buf = xd.new_zeros(n_local * cap + 1, d).index_put((slot,), rows)
        expert_out = self._apply_experts(buf[:-1].view(n_local, cap, d))
        # combine: each kept choice reads its slot back, weighted, in fp32
        w = weights
        if self._ep_group is not None:
            w = _c_identity(w, self._ep_group)
        w = w.to(expert_out.dtype)
        out = torch.cat([expert_out.reshape(n_local * cap, d),
                         expert_out.new_zeros(1, d)])
        picked = out[slot].view(t, k, d)
        y = (picked.float() * w.float().unsqueeze(-1)).sum(1)
        if self._ep_group is not None:
            y = _mp_allreduce(y, self._ep_group)
        return y.to(expert_out.dtype).reshape(orig_shape)

    def forward_einsum(self, x):
        """The JAX package's form: the one-hot ``[T, E, C]`` dispatch and
        combine einsums (the oracle of :meth:`forward`; one rank of
        every expert only)."""
        if self._ep_group is not None:
            raise NotImplementedError("the einsum form holds every expert")
        orig_shape = x.shape
        xf = x.reshape(-1, orig_shape[-1])
        weights, experts, places, keep, cap = self._plan(xf)
        disp, comb = dispatch_masks(weights, experts, places, keep,
                                    self.num_expert, cap)
        disp, xd = amp.cast("einsum", disp, xf)
        expert_in = torch.einsum("tec,tm->ecm", disp, xd)
        expert_out = self._apply_experts(expert_in)
        comb = comb.to(expert_out.dtype)
        yf = torch.einsum("ecm,tec->tm", expert_out, comb)
        return yf.reshape(orig_shape)

    def _apply_experts(self, expert_in):
        """This rank's experts on their ``[C, M]`` rows: stacked (vmap of
        the first over the stacked parameters) or one by one."""
        local = list(self.experts)
        use_loop = (not self._experts_stackable
                    or (self.training and self._experts_stochastic))
        if use_loop:
            nothing_to_shard = (self.num_expert <= 1 or not any(
                True for e in local for _ in e.parameters()))
            if not self._experts_stackable and not nothing_to_shard:
                warnings.warn(
                    "MoELayer: heterogeneous (or buffer-carrying) experts "
                    "cannot be stacked — falling back to replicated "
                    "per-expert loop (no ep sharding of expert compute)",
                    RuntimeWarning)
            return torch.stack([e(expert_in[i])
                                for i, e in enumerate(local)], 0)
        names = [n for n, _ in local[0].named_parameters()]
        params = [dict(e.named_parameters()) for e in local]
        stacked = {n: torch.stack([p[n] for p in params], 0) for n in names}
        exp0 = local[0]

        def one(ps, xa):
            return torch.func.functional_call(exp0, ps, (xa,))
        return torch.func.vmap(one)(stacked, expert_in)


class ClipGradForMOEByGlobalNorm(ClipGradByGlobalNorm):
    """ref: ``moe/grad_clip.py`` — the global norm's square is the dense
    parameters' sum plus the experts' partial sums all-reduced over the
    ep group (``moe_group``; default: the fleet topology's), as the
    reference's MoE clip computes it; on one rank of every expert it is
    the JAX package's global norm.  ``is_expert_param_func`` (default:
    :func:`is_expert_param`) names the expert parameters."""

    def __init__(self, clip_norm, is_expert_param_func=None,
                 moe_group=None, group_name="default_moe_group"):
        super().__init__(clip_norm, group_name=group_name)
        self.is_expert_param_func = is_expert_param_func
        self.moe_group = moe_group

    def _squared_norm(self, params_grads) -> Optional[torch.Tensor]:
        is_expert = self.is_expert_param_func or is_expert_param
        pg = [(p, g) for p, g in params_grads if g is not None]
        dense = _sq_sum([g for p, g in pg if not is_expert(p)])
        moe = _sq_sum([g for p, g in pg if is_expert(p)])
        group = self.moe_group
        if group is None:
            hcg = get_hybrid_communicate_group()
            group = hcg.get_expert_parallel_group() if hcg else None
        if group is not None and group.nranks > 1:
            if moe is None:
                dev = pg[0][1].device if pg else default_device(None)
                moe = torch.zeros((), dtype=torch.float32, device=dev)
            moe = group_sum(moe, group)
        if dense is None:
            return moe
        return dense if moe is None else dense + moe
