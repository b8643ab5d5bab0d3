"""GPT model family; counterpart of ``paddle_tpu/models/gpt.py``.

Parameters keep the JAX package's ``state_dict`` names and ``[in, out]``
weight layout (``gpt.layers.{i}.attn.qkv_proj.weight [H, 3H]``,
``gpt.embeddings.word_embeddings.weight [V, H]``, ...), so weights carry
over without transposes (``models.carry``).  The port's GPT is an
inference model: a dense, cache-free :meth:`GPTForPretraining.forward`
(the cross-check) and the paged serving step
(:meth:`GPTForPretraining.build_ragged_decode_step`).  Training waits
for a later slice.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import default_device, generator
from ..ops.fused_decode import reference_layer_norm

__all__ = ["GPTConfig", "PRESETS", "gpt_config", "GPTForPretraining"]


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
    """``y = x @ weight + bias`` with the Paddle ``[in, out]`` weight."""

    def __init__(self, n_in: int, n_out: int, *, std: float, gen, device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_in, n_out, device=device,
                                               dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(n_out, device=device,
                                             dtype=torch.float32))
        with torch.no_grad():
            self.weight.normal_(0.0, std, generator=gen)

    def forward(self, x):
        return torch.matmul(x, self.weight) + self.bias


class LayerNorm(nn.Module):
    """LayerNorm with the JAX package's reference numerics."""

    def __init__(self, n: int, *, device, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(n, device=device,
                                              dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(n, device=device,
                                             dtype=torch.float32))

    def forward(self, x):
        return reference_layer_norm(x, self.weight, self.bias, self.eps)


class Embedding(nn.Module):
    def __init__(self, n: int, dim: int, *, std: float, gen, device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n, dim, device=device,
                                               dtype=torch.float32))
        with torch.no_grad():
            self.weight.normal_(0.0, std, generator=gen)

    def forward(self, ids):
        return self.weight[ids]


class MultiHeadAttention(nn.Module):
    """Causal self-attention with the packed ``[H, 3H]`` qkv projection
    (columns: contiguous q, k, v thirds)."""

    def __init__(self, c: GPTConfig, **kw):
        super().__init__()
        self.num_heads = c.num_heads
        self.head_dim = c.hidden_size // c.num_heads
        std = c.initializer_range
        self.qkv_proj = Linear(c.hidden_size, 3 * c.hidden_size, std=std,
                               **kw)
        self.out_proj = Linear(c.hidden_size, c.hidden_size, std=std, **kw)

    def forward(self, x):
        b, s, hidden = x.shape
        q, k, v = self.qkv_proj(x).split(hidden, dim=-1)
        q, k, v = (t.reshape(b, s, self.num_heads, self.head_dim)
                   .transpose(1, 2).float() for t in (q, k, v))
        logits = torch.matmul(q, k.transpose(-1, -2)) \
            / math.sqrt(self.head_dim)
        causal = torch.ones(s, s, dtype=torch.bool,
                            device=x.device).tril()
        logits = logits.masked_fill(~causal, -1e30)
        ctx = torch.matmul(torch.softmax(logits, dim=-1), v)
        ctx = ctx.transpose(1, 2).reshape(b, s, hidden).to(x.dtype)
        return self.out_proj(ctx)


class GPTMLP(nn.Module):
    def __init__(self, c: GPTConfig, **kw):
        super().__init__()
        std = c.initializer_range
        self.fc1 = Linear(c.hidden_size, c.intermediate_size, std=std, **kw)
        self.fc2 = Linear(c.intermediate_size, c.hidden_size,
                          std=std / math.sqrt(2.0 * c.num_layers), **kw)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class GPTBlock(nn.Module):
    def __init__(self, c: GPTConfig, *, device, gen):
        super().__init__()
        self.ln1 = LayerNorm(c.hidden_size, device=device)
        self.attn = MultiHeadAttention(c, gen=gen, device=device)
        self.ln2 = LayerNorm(c.hidden_size, device=device)
        self.mlp = GPTMLP(c, gen=gen, device=device)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))


class GPTEmbeddings(nn.Module):
    def __init__(self, c: GPTConfig, *, device, gen):
        super().__init__()
        kw = dict(std=c.initializer_range, gen=gen, device=device)
        self.word_embeddings = Embedding(c.vocab_size, c.hidden_size, **kw)
        self.position_embeddings = Embedding(c.max_position_embeddings,
                                             c.hidden_size, **kw)

    def forward(self, input_ids):
        s = input_ids.shape[-1]
        if s > self.position_embeddings.weight.shape[0]:
            raise ValueError(f"sequence length {s} exceeds "
                             "max_position_embeddings "
                             f"{self.position_embeddings.weight.shape[0]}")
        pos = torch.arange(s, device=input_ids.device)
        return self.word_embeddings(input_ids) \
            + self.position_embeddings(pos)


class GPTModel(nn.Module):
    """Transformer decoder stack."""

    def __init__(self, c: GPTConfig, *, device, gen):
        super().__init__()
        self.embeddings = GPTEmbeddings(c, device=device, gen=gen)
        self.layers = nn.ModuleList([GPTBlock(c, device=device, gen=gen)
                                     for _ in range(c.num_layers)])
        self.final_ln = LayerNorm(c.hidden_size, device=device)

    def forward(self, input_ids):
        x = self.embeddings(input_ids)
        for block in self.layers:
            x = block(x)
        return self.final_ln(x)


class GPTForPretraining(nn.Module):
    """GPT with the LM head tied to the word embedding (or its own
    ``lm_head_weight [V, H]``).

    ``device=None`` means the CUDA card and raises without one; pass
    ``device="cpu"`` for the CPU.  Weights are fp32, drawn from a
    ``torch.Generator`` seeded with ``seed`` on that device: Normal(0,
    0.02) for embeddings and projections, 0.02/sqrt(2L) for ``fc2``,
    zero biases, unit LayerNorm scales — the JAX package's initializers
    (its random bits differ; carry weights over with
    ``models.carry.load_paddle_tpu_state`` to compare)."""

    def __init__(self, config: GPTConfig, *, device=None, seed: int = 0):
        super().__init__()
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
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.gpt.final_ln.weight.device

    def lm_weight(self):
        return self.gpt.embeddings.word_embeddings.weight \
            if self.config.tie_word_embeddings else self.lm_head_weight

    @torch.no_grad()
    def forward(self, input_ids):
        """Dense, cache-free forward (eval only): ``input_ids [B, S]`` ->
        ``logits [B, S, V]``."""
        h = self.gpt(input_ids)
        return torch.matmul(h, self.lm_weight().transpose(0, 1))

    def build_ragged_decode_step(self):
        """Batched serving-engine step over paged KV pools; see
        ``models.generation.build_ragged_decode_step``."""
        from .generation import build_ragged_decode_step
        return build_ragged_decode_step(self)
