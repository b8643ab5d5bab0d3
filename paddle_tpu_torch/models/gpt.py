"""GPT model family; counterpart of ``paddle_tpu/models/gpt.py``.

Parameters keep the JAX package's ``state_dict`` names and ``[in, out]``
weight layout (``gpt.layers.{i}.attn.qkv_proj.weight [H, 3H]``,
``gpt.embeddings.word_embeddings.weight [V, H]``, ...), so weights carry
over without transposes (``models.carry``).

:meth:`GPTForPretraining.forward` is the dense forward.  In eval mode
(the mode a new model starts in) it runs under ``torch.no_grad``; in
training mode (``model.train()``, which ``jit.train_step`` sets) it
records autograd and applies dropout from the model's
``torch.Generator``.  Attention goes through
``nn.functional.scaled_dot_product_attention`` (the flash kernels K1 on
CUDA) and LayerNorm through ``nn.functional.layer_norm`` (K2), as the
JAX model's ``F.scaled_dot_product_attention`` and ``nn.LayerNorm`` do;
every op reads the amp state.  ``model.loss_fn`` is the pretraining
criterion.  ``use_recompute`` recomputes each block in the backward
(``torch.utils.checkpoint``).  The paged serving step
(:meth:`GPTForPretraining.build_ragged_decode_step`) keeps the
``fused_decode`` LayerNorm numerics, as the JAX serving step does.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import amp
from ..device import default_device, generator
from ..nn import functional as F

__all__ = ["GPTConfig", "PRESETS", "gpt_config", "GPTForPretraining",
           "GPTPretrainingCriterion"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 2048
    num_layers: int = 24
    num_heads: int = 16
    max_position_embeddings: int = 2048
    intermediate_size: Optional[int] = None  # default 4*hidden
    hidden_dropout_prob: float = 0.1
    attention_dropout_prob: float = 0.1
    initializer_range: float = 0.02
    use_recompute: bool = False
    sequence_parallel: bool = False
    tie_word_embeddings: bool = True

    def __post_init__(self):
        if self.intermediate_size is None:
            self.intermediate_size = 4 * self.hidden_size


PRESETS = {
    # name: (layers, hidden, heads, seq)
    "gpt3-125M": dict(num_layers=12, hidden_size=768, num_heads=12),
    "gpt3-350M": dict(num_layers=24, hidden_size=1024, num_heads=16),
    "gpt3-760M": dict(num_layers=24, hidden_size=1536, num_heads=16),
    "gpt3-1.3B": dict(num_layers=24, hidden_size=2048, num_heads=16),
    "gpt3-2.7B": dict(num_layers=32, hidden_size=2560, num_heads=32),
    "gpt3-6.7B": dict(num_layers=32, hidden_size=4096, num_heads=32),
    "gpt3-13B": dict(num_layers=40, hidden_size=5120, num_heads=40),
    "tiny": dict(num_layers=2, hidden_size=64, num_heads=4, vocab_size=512,
                 max_position_embeddings=128),
}


def gpt_config(name: str, **overrides) -> GPTConfig:
    cfg = dict(PRESETS[name])
    cfg.update(overrides)
    return GPTConfig(**cfg)


class Linear(nn.Module):
    """``y = x @ weight + bias`` with the Paddle ``[in, out]`` weight
    (``bias=False``: no bias parameter)."""

    def __init__(self, n_in: int, n_out: int, *, std: float, gen, device,
                 bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_in, n_out, device=device,
                                               dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(
            n_out, device=device, dtype=torch.float32)) if bias else None
        with torch.no_grad():
            self.weight.normal_(0.0, std, generator=gen)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    """``nn.LayerNorm`` of the JAX package: fp32 statistics and affine
    (K2 on CUDA), black-listed under amp (kept fp32 by ``decorate``)."""

    def __init__(self, n: int, *, device, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(n, device=device,
                                              dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(n, device=device,
                                             dtype=torch.float32))

    def forward(self, x):
        return F.layer_norm(x, self.weight.shape[0], self.weight, self.bias,
                            self.eps)


class Embedding(nn.Module):
    def __init__(self, n: int, dim: int, *, std: float, gen, device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n, dim, device=device,
                                               dtype=torch.float32))
        with torch.no_grad():
            self.weight.normal_(0.0, std, generator=gen)

    def forward(self, ids):
        return F.embedding(ids, self.weight)


class MultiHeadAttention(nn.Module):
    """Causal self-attention with the packed ``[H, 3H]`` qkv projection
    (columns: contiguous q, k, v thirds)."""

    def __init__(self, c: GPTConfig, *, gen, device):
        super().__init__()
        self.num_heads = c.num_heads
        self.head_dim = c.hidden_size // c.num_heads
        self.attn_drop = c.attention_dropout_prob
        self.gen = gen
        std = c.initializer_range
        self.qkv_proj = Linear(c.hidden_size, 3 * c.hidden_size, std=std,
                               gen=gen, device=device)
        self.out_proj = Linear(c.hidden_size, c.hidden_size, std=std,
                               gen=gen, device=device)

    def forward(self, x):
        b, s, hidden = x.shape
        qkv = self.qkv_proj(x).reshape(b, s, 3, self.num_heads,
                                       self.head_dim)
        out = F.scaled_dot_product_attention(
            qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
            dropout_p=self.attn_drop if self.training else 0.0,
            is_causal=True, training=self.training, generator=self.gen)
        return self.out_proj(out.reshape(b, s, hidden))


class GPTMLP(nn.Module):
    def __init__(self, c: GPTConfig, **kw):
        super().__init__()
        std = c.initializer_range
        self.fc1 = Linear(c.hidden_size, c.intermediate_size, std=std, **kw)
        self.fc2 = Linear(c.intermediate_size, c.hidden_size,
                          std=std / math.sqrt(2.0 * c.num_layers), **kw)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate=True))


class GPTBlock(nn.Module):
    def __init__(self, c: GPTConfig, *, device, gen):
        super().__init__()
        self.ln1 = LayerNorm(c.hidden_size, device=device)
        self.attn = MultiHeadAttention(c, gen=gen, device=device)
        self.ln2 = LayerNorm(c.hidden_size, device=device)
        self.mlp = GPTMLP(c, gen=gen, device=device)
        self.drop_p = c.hidden_dropout_prob
        self.gen = gen

    def forward(self, x):
        h = F.dropout(self.attn(self.ln1(x)), self.drop_p, self.training,
                      self.gen)
        x = x + h
        h = F.dropout(self.mlp(self.ln2(x)), self.drop_p, self.training,
                      self.gen)
        return x + h


class GPTEmbeddings(nn.Module):
    def __init__(self, c: GPTConfig, *, device, gen):
        super().__init__()
        kw = dict(std=c.initializer_range, gen=gen, device=device)
        self.word_embeddings = Embedding(c.vocab_size, c.hidden_size, **kw)
        self.position_embeddings = Embedding(c.max_position_embeddings,
                                             c.hidden_size, **kw)
        self.drop_p = c.hidden_dropout_prob
        self.gen = gen

    def forward(self, input_ids):
        s = input_ids.shape[-1]
        if s > self.position_embeddings.weight.shape[0]:
            raise ValueError(f"sequence length {s} exceeds "
                             "max_position_embeddings "
                             f"{self.position_embeddings.weight.shape[0]}")
        pos = torch.arange(s, device=input_ids.device)
        x = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        return F.dropout(x, self.drop_p, self.training, self.gen)


class GPTModel(nn.Module):
    """Transformer decoder stack."""

    def __init__(self, c: GPTConfig, *, device, gen):
        super().__init__()
        self.embeddings = GPTEmbeddings(c, device=device, gen=gen)
        self.layers = nn.ModuleList([GPTBlock(c, device=device, gen=gen)
                                     for _ in range(c.num_layers)])
        self.final_ln = LayerNorm(c.hidden_size, device=device)
        self.use_recompute = c.use_recompute
        self.gen = gen

    def forward(self, input_ids):
        x = self.embeddings(input_ids)
        for block in self.layers:
            if self.use_recompute and self.training:
                x = _recompute(block, x, self.gen)
            else:
                x = block(x)
        return self.final_ln(x)


def _recompute(block, x, gen):
    """``fleet.recompute`` of one block: its activations are dropped and
    recomputed in the backward.  The recomputation replays the dropout
    bits of the forward: it runs from the generator state the forward
    started from, then hands the generator back where it was."""
    state = gen.get_state()
    first = [True]

    def run(inp):
        if first[0]:
            first[0] = False
            return block(inp)
        now = gen.get_state()
        gen.set_state(state)
        try:
            return block(inp)
        finally:
            gen.set_state(now)

    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


class GPTForPretraining(nn.Module):
    """GPT with the LM head tied to the word embedding (or its own
    ``lm_head_weight [V, H]``).

    ``device=None`` means the CUDA card and raises without one; pass
    ``device="cpu"`` for the CPU.  Weights are fp32, drawn from a
    ``torch.Generator`` seeded with ``seed`` on that device: Normal(0,
    0.02) for embeddings and projections, 0.02/sqrt(2L) for ``fc2``,
    zero biases, unit LayerNorm scales — the JAX package's initializers
    (its random bits differ; carry weights over with
    ``models.carry.load_paddle_tpu_state`` to compare).  The same
    generator, past the initializers, draws the dropout bits.
    ``sequence_parallel=True`` raises until the distributed slice."""

    def __init__(self, config: GPTConfig, *, device=None, seed: int = 0):
        super().__init__()
        if config.sequence_parallel:
            raise NotImplementedError("sequence_parallel waits for the "
                                      "distributed slice")
        dev = default_device(device)
        gen = generator(seed, dev)
        self.config = config
        self.gpt = GPTModel(config, device=dev, gen=gen)
        if not config.tie_word_embeddings:
            self.lm_head_weight = nn.Parameter(torch.empty(
                config.vocab_size, config.hidden_size, device=dev,
                dtype=torch.float32))
            with torch.no_grad():
                self.lm_head_weight.normal_(0.0, config.initializer_range,
                                            generator=gen)
        self.loss_fn = GPTPretrainingCriterion()
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.gpt.final_ln.weight.device

    def lm_weight(self):
        return self.gpt.embeddings.word_embeddings.weight \
            if self.config.tie_word_embeddings else self.lm_head_weight

    def forward(self, input_ids):
        """Dense, cache-free forward: ``input_ids [B, S]`` -> ``logits
        [B, S, V]``; under ``torch.no_grad`` in eval mode."""
        with torch.set_grad_enabled(self.training
                                    and torch.is_grad_enabled()):
            h = self.gpt(input_ids)
            return F.matmul(h, self.lm_weight(), transpose_y=True)

    def build_ragged_decode_step(self):
        """Batched serving-engine step over paged KV pools; see
        ``models.generation.build_ragged_decode_step``."""
        from .generation import build_ragged_decode_step
        return build_ragged_decode_step(self)


class GPTPretrainingCriterion(nn.Module):
    """Next-token cross entropy, the mean over valid tokens only
    (``labels != -100``): the JAX criterion's masked sum over the mask
    count.  Each op casts its inputs by the amp rule, as the JAX ops do
    under O2 (the product and the clip run in the low dtype, the sums in
    fp32, so the O2 loss comes out in the low dtype)."""

    ignore_index = -100

    def forward(self, logits, labels):
        b, s, v = logits.shape
        flat = labels.reshape(b * s)
        loss = F.cross_entropy(logits.reshape(b * s, v), flat,
                               ignore_index=self.ignore_index,
                               reduction="none")
        mask = (flat != self.ignore_index).to(loss.dtype)
        loss, mask = amp.cast("multiply", loss, mask)
        (num,) = amp.cast("sum", loss * mask)
        (den,) = amp.cast("sum", mask)
        (den,) = amp.cast("clip", den.sum())
        num, den = amp.cast("divide", num.sum(), den.clamp(min=1.0))
        return num / den
