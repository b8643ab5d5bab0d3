"""ERNIE-MoE; counterpart of ``paddle_tpu/models/ernie_moe.py``.

A post-LN ERNIE encoder whose FFN is the incubate ``MoELayer`` in every
``moe_every``-th block (``incubate.distributed.models.moe``), pretrained
with an MLM head tied to the word embedding and the gates' balance
losses added to the criterion.  Parameter names and ``[in, out]`` shapes
are the JAX package's (``ernie.blocks.{i}.ffn.experts.{e}.0.weight``
...), with global expert indices, so ``models.carry`` carries its
weights at any expert degree.

The dense layers are the fleet mp layers (at mp 1, as the JAX model
builds them), attention goes through ``nn.functional.
scaled_dot_product_attention`` (the flash kernels K1, non-causal, when
no dropout is live), LayerNorm through ``nn.functional.layer_norm`` (K2)
and each op applies the amp O2 rule with the JAX op's name.  Weights are
fp32, drawn on ``device`` from a generator seeded with ``seed`` in the
JAX model's order (Normal(0, 0.02), XavierNormal for the gates, zero
biases, unit LayerNorm scales), except each expert: expert ``e`` of block
``i`` draws from a generator of its own (:func:`expert_seed`), so it is
the same tensor at any expert degree, and under an ep group a rank
builds the other ranks' experts on the ``meta`` device, which
``MoELayer`` drops.  Dropout draws from the model's generator.

:meth:`ErnieMoEForPretraining.loss_fn` gives the masked mean over the
global batch once the ranks' losses are averaged: under a fleet topology
whose data group (dp x sharding) has n ranks, a rank returns its share,
its masked NLL sum times n over the count summed over the group (a
rank's MLM labels may count differently).  ``jit.train_step``'s average
of the ranks' losses is then the global masked mean, and the data
group's average of the gradients its gradient.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from .. import amp
from ..device import default_device, generator
from ..distributed.fleet.meta_parallel.parallel_layers.mp_layers import (
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)
from ..incubate.distributed.models.moe import MoELayer
from ..incubate.distributed.models.moe.moe_layer import (
    group_sum, token_group)
from ..nn import functional as F
from ..nn.initializer import Normal, ParamAttr
from ..nn.layers import GELU, Linear
from .gpt import Embedding, LayerNorm

__all__ = ["ErnieMoEConfig", "ErnieMoEModel", "ErnieMoEForPretraining",
           "ErnieMoEBlock", "ernie_moe_config", "ERNIE_MOE_PRESETS",
           "expert_seed"]


@dataclass
class ErnieMoEConfig:
    vocab_size: int = 40000
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: Optional[int] = None
    max_position_embeddings: int = 512
    num_experts: int = 8
    moe_every: int = 2                 # MoE FFN every k-th block
    top_k: int = 2
    gate: str = "gshard"
    capacity_factor: float = 1.25
    balance_loss_weight: float = 0.01
    hidden_dropout_prob: float = 0.1
    attention_dropout_prob: float = 0.1
    initializer_range: float = 0.02

    def __post_init__(self):
        if self.intermediate_size is None:
            self.intermediate_size = 4 * self.hidden_size


ERNIE_MOE_PRESETS = {
    "ernie-moe-base": dict(num_layers=12, hidden_size=768, num_heads=12,
                           num_experts=64),
    "tiny": dict(num_layers=2, hidden_size=64, num_heads=4,
                 vocab_size=256, max_position_embeddings=128,
                 num_experts=8, moe_every=1),
}


def ernie_moe_config(name: str, **overrides) -> ErnieMoEConfig:
    cfg = dict(ERNIE_MOE_PRESETS[name])
    cfg.update(overrides)
    return ErnieMoEConfig(**cfg)


def expert_seed(seed: int, block: int, expert: int) -> int:
    """The seed of expert ``expert``'s generator in block ``block``."""
    return (seed + 1) * 1_000_003 + block * 4099 + expert


def _init(c: ErnieMoEConfig) -> ParamAttr:
    return ParamAttr(initializer=Normal(std=c.initializer_range))


class _Attention(nn.Module):
    def __init__(self, c: ErnieMoEConfig, *, gen, device):
        super().__init__()
        self.num_heads = c.num_heads
        self.head_dim = c.hidden_size // c.num_heads
        self.hidden_size = c.hidden_size
        self.attn_drop = c.attention_dropout_prob
        self.gen = gen
        kw = dict(generator=gen, device=device)
        self.qkv_proj = ColumnParallelLinear(
            c.hidden_size, 3 * c.hidden_size, weight_attr=_init(c),
            has_bias=True, gather_output=False, **kw)
        self.out_proj = RowParallelLinear(
            c.hidden_size, c.hidden_size, weight_attr=_init(c),
            has_bias=True, input_is_parallel=True, **kw)

    def forward(self, x):
        b, s, h = x.shape
        qkv = self.qkv_proj(x).reshape(b, s, 3, self.num_heads,
                                       self.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        out = F.scaled_dot_product_attention(
            q, k, v, dropout_p=self.attn_drop if self.training else 0.0,
            is_causal=False, training=self.training, generator=self.gen)
        return self.out_proj(out.reshape(b, s, h))


class _DenseFFN(nn.Module):
    def __init__(self, c: ErnieMoEConfig, *, gen, device):
        super().__init__()
        kw = dict(generator=gen, device=device)
        self.fc1 = ColumnParallelLinear(c.hidden_size, c.intermediate_size,
                                        weight_attr=_init(c), has_bias=True,
                                        gather_output=False, **kw)
        self.fc2 = RowParallelLinear(c.intermediate_size, c.hidden_size,
                                     weight_attr=_init(c), has_bias=True,
                                     input_is_parallel=True, **kw)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


def _make_expert(c: ErnieMoEConfig, *, gen=None, device=None):
    """One expert: Linear -> GELU -> Linear (``device="meta"``: a
    placeholder, nothing drawn)."""
    kw = dict(weight_attr=_init(c), generator=gen, device=device)
    return nn.Sequential(Linear(c.hidden_size, c.intermediate_size, **kw),
                         GELU(),
                         Linear(c.intermediate_size, c.hidden_size, **kw))


def _add(x, h):
    """``x + h`` under the amp rule (post-LN: x is the fp32 norm's
    output, h the sublayer's)."""
    x, h = amp.cast("add", x, h)
    return x + h


class ErnieMoEBlock(nn.Module):
    """Post-LN encoder block; the FFN is MoE on selected layers
    (``index`` is the block's, for its experts' seeds)."""

    def __init__(self, c: ErnieMoEConfig, use_moe: bool, *, gen, device,
                 seed: int = 0, index: int = 0):
        super().__init__()
        self.attention = _Attention(c, gen=gen, device=device)
        self.ln1 = LayerNorm(c.hidden_size, device=device, eps=1e-12)
        self.use_moe = use_moe
        if use_moe:
            self.ffn = MoELayer(
                d_model=c.hidden_size,
                experts=self._experts(c, device, seed, index),
                gate={"type": c.gate, "top_k": c.top_k},
                capacity_factor=c.capacity_factor, generator=gen,
                device=device)
        else:
            self.ffn = _DenseFFN(c, gen=gen, device=device)
        self.ln2 = LayerNorm(c.hidden_size, device=device, eps=1e-12)
        self.drop_p = c.hidden_dropout_prob
        self.gen = gen

    @staticmethod
    def _experts(c, device, seed, index):
        """Every expert, those of other ep ranks on the meta device."""
        from ..distributed.fleet.base.topology import (
            get_hybrid_communicate_group)
        hcg = get_hybrid_communicate_group()
        ep = hcg.get_expert_parallel_world_size() if hcg else 1
        rank = hcg.get_expert_parallel_rank() if hcg else 0
        per = c.num_experts // ep if c.num_experts % ep == 0 else None
        out = []
        for e in range(c.num_experts):
            mine = per is None or rank * per <= e < (rank + 1) * per
            out.append(_make_expert(
                c, gen=generator(expert_seed(seed, index, e), device)
                if mine else None, device=device if mine else "meta"))
        return out

    def forward(self, x):
        h = self.attention(x)
        h = F.dropout(h, self.drop_p, training=self.training,
                      generator=self.gen)
        x = self.ln1(_add(x, h))
        h = self.ffn(x)
        h = F.dropout(h, self.drop_p, training=self.training,
                      generator=self.gen)
        return self.ln2(_add(x, h))

    def gate_loss(self):
        if self.use_moe:
            return self.ffn.gate.get_loss()
        return None


class ErnieMoEModel(nn.Module):
    def __init__(self, config: ErnieMoEConfig, *, gen, device,
                 seed: int = 0):
        super().__init__()
        self.config = c = config
        kw = dict(gen=gen, device=device)
        self.word_embeddings = VocabParallelEmbedding(
            c.vocab_size, c.hidden_size, weight_attr=_init(c),
            generator=gen, device=device)
        self.position_embeddings = Embedding(
            c.max_position_embeddings, c.hidden_size,
            std=c.initializer_range, **kw)
        self.layer_norm = LayerNorm(c.hidden_size, device=device, eps=1e-12)
        self.drop_p = c.hidden_dropout_prob
        self.gen = gen
        self.blocks = nn.ModuleList([
            ErnieMoEBlock(c, use_moe=((i + 1) % c.moe_every == 0), seed=seed,
                          index=i, **kw)
            for i in range(c.num_layers)])

    def forward(self, input_ids):
        s = input_ids.shape[-1]
        pos = torch.arange(s, device=input_ids.device)
        x = _add(self.word_embeddings(input_ids),
                 self.position_embeddings(pos))
        x = self.layer_norm(x)
        x = F.dropout(x, self.drop_p, training=self.training,
                      generator=self.gen)
        for blk in self.blocks:
            x = blk(x)
        return x

    def gate_losses(self):
        return [l for l in (blk.gate_loss() for blk in self.blocks)
                if l is not None]


class ErnieMoEForPretraining(nn.Module):
    """MLM head tied to the word embedding and the balance-loss-weighted
    criterion (:meth:`loss_fn`).  ``device=None`` means the CUDA card;
    pass ``device="cpu"`` for the CPU.  A new model is in eval mode,
    where ``forward`` runs under ``torch.no_grad`` (``jit.train_step``
    puts it in training mode)."""

    def __init__(self, config: ErnieMoEConfig, *, device=None,
                 seed: int = 0):
        super().__init__()
        dev = default_device(device)
        gen = generator(seed, dev)
        self.config = config
        self.ernie = ErnieMoEModel(config, gen=gen, device=dev, seed=seed)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.ernie.layer_norm.weight.device

    @property
    def generator(self) -> torch.Generator:
        return self.ernie.gen

    def forward(self, input_ids):
        with torch.set_grad_enabled(self.training
                                    and torch.is_grad_enabled()):
            h = self.ernie(input_ids)
            return F.matmul(h, self.ernie.word_embeddings.weight,
                            transpose_y=True)

    def loss_fn(self, logits, labels):
        """The masked mean NLL over the global batch (``labels == -100``
        ignored; under a data group this rank's share of it, which the
        ranks' average makes global) plus ``balance_loss_weight`` times
        each gate's loss, with the JAX ops' amp casts (module
        docstring)."""
        b, s, v = logits.shape
        flat_logits = logits.reshape(b * s, v)
        flat = labels.reshape(b * s)
        safe = torch.where(flat == -100, torch.zeros_like(flat), flat)
        (lg,) = amp.cast("log_softmax", flat_logits.float())
        (logp,) = amp.cast("take_along_axis", torch.log_softmax(lg, -1))
        nll = -logp.gather(1, safe.reshape(b * s, 1)).reshape(b * s)
        mask = (flat != -100).to(nll.dtype)
        nll, mask = amp.cast("multiply", nll, mask)
        (prod,) = amp.cast("sum", nll * mask)
        (m,) = amp.cast("sum", mask)
        group = token_group()
        n = group.nranks if group is not None else 1
        den = group_sum(m.sum(), group)
        (den,) = amp.cast("clip", den)
        num, den = amp.cast("divide", prod.sum() * n, den.clamp(min=1.0))
        loss = num / den
        for gl in self.ernie.gate_losses():
            (gl,) = amp.cast("scale", gl)
            loss = _add(loss, self.config.balance_loss_weight * gl)
        return loss
