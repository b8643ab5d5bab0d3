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
(``fleet.recompute``, replaying the dropout bits).  With a KV cache
(``past``, ``use_cache``) the positions start at the cache's length and
K1 aligns the causal mask bottom-right; ``last_logits_only`` runs the
head on the last position only.  With one ``PagedLayerView`` per layer
(eager paged ``generate``) the positions start at the rows' common
length and attention appends to the page pools and runs
``ops.paged_attention`` (K9's counterpart on CUDA).  The paged serving
step
(:meth:`GPTForPretraining.build_ragged_decode_step`) and the compiled
decode loop's step (:meth:`GPTForPretraining.build_decode_step`, on the
fused decode kernels K6a/K6b/K6c) keep the ``fused_decode`` LayerNorm
numerics, as the JAX steps do; ``generate`` is
``models.generation.generate``.

Under the fleet topology's model parallel degree ``mp`` the layers are
the tensor-parallel ones (``fleet.meta_parallel.parallel_layers``), as
in the JAX package: the packed qkv and ``fc1`` column-parallel (the qkv
split by heads within each of its q, k, v thirds), ``out_proj`` and
``fc2`` row-parallel, the word embedding vocab-parallel, and the tied
head computing vocab-split logits ``[B, S, V/mp]`` for
``ParallelCrossEntropy``.  Every rank draws the one-rank model's weights
in its order and keeps its shards.  ``sequence_parallel=True`` is
Megatron SP: between blocks the activations are split along the sequence
over mp, gathered before qkv and fc1, reduce-scattered after out_proj
and fc2; the LayerNorm parameters are marked sequence parallel and their
gradients summed over mp by the hooks the model registers.  Under a sep
or cp axis each rank holds its sequence chunk (``jit.train_step`` slices
it), the positions are the chunk's global ones, attention takes the
Ulysses or ring route, and the criterion sums the loss and the token
count over that group before dividing (SP then stays off, as in the JAX
package).  Dropout on what every mp rank holds draws from the model's
generator (the same bits on every mp rank); dropout on a rank's own
heads or sequence chunk from a second generator seeded ``seed + 1024 +``
the rank's index (the reference's ``local_seed`` rule).  The KV-cache
and decode paths run at one rank only.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from .. import amp
from ..device import default_device, generator
from ..distributed.communication.collective_ops import all_reduce
from ..distributed.fleet.base.topology import get_hybrid_communicate_group
from ..distributed.fleet.meta_parallel import segment_parallel
from ..distributed.fleet.meta_parallel.parallel_layers.mp_layers import (
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding, column_linear)
from ..distributed.fleet.recompute import recompute
from ..distributed.fleet.utils.sequence_parallel_utils import (
    ColumnSequenceParallelLinear, RowSequenceParallelLinear,
    ScatterOp, mark_as_sequence_parallel_parameter,
    register_sequence_parallel_allreduce_hooks)
from ..nn import functional as F
from ..nn.initializer import Normal, ParamAttr
from ..ops import fused_decode as _fd
from ..ops.paged_attention import PagedLayerView

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


class ParallelContext:
    """The fleet topology's view of one model, read when it is built:
    the mp degree and rank, whether Megatron SP runs (asked, mp above 1
    and no sep / cp axis), the live sep / cp group, and the generators
    of the module docstring (``gen`` for what every mp rank holds,
    ``local_gen`` for a rank's own heads or sequence chunk)."""

    def __init__(self, sequence_parallel: bool, seed: int, dev, gen):
        hcg = get_hybrid_communicate_group()
        self.mp = hcg.get_model_parallel_world_size() if hcg else 1
        self.mp_rank = hcg.get_model_parallel_rank() if hcg else 0
        self.seq_group = segment_parallel.seq_parallel_group()
        self.sp = bool(sequence_parallel) and self.mp > 1 and \
            self.seq_group is None
        self.gen = gen
        split = self.mp > 1 or self.seq_group is not None
        if split:
            index = self.mp_rank + self.mp * (
                self.seq_group.rank if self.seq_group is not None else 0)
            self.local_gen = generator(seed + 1024 + index, dev)
        else:
            self.local_gen = gen
        self.seq_split = self.sp or self.seq_group is not None

    @property
    def hidden_gen(self):
        """Dropout on the blocks' activations: split along the sequence
        under SP or sep / cp."""
        return self.local_gen if self.seq_split else self.gen

    @property
    def generators(self):
        return (self.gen,) if self.local_gen is self.gen \
            else (self.gen, self.local_gen)

    def seq_offset(self, s: int) -> int:
        """The global position of this rank's first row under sep / cp."""
        return self.seq_group.rank * s if self.seq_group is not None else 0

    def column(self, x, layers):
        """The column-parallel products of one input, one a layer
        (``mp_layers.column_linear``: the input gathered along the
        sequence under SP, its gradient summed in fp32)."""
        return column_linear(x, [(m.weight, m.bias) for m in layers],
                             sp=self.sp)

    def head(self, h, weight, last_only: bool = False):
        """Logits of the ``[V, H]`` head: under mp this rank's vocabulary
        columns (``weight`` is its rows)."""
        if self.mp == 1:
            if last_only:
                h = h[:, -1:]
            return F.matmul(h, weight, transpose_y=True)
        (logits,) = column_linear(h, [(weight.t(), None)], sp=self.sp)
        return logits[:, -1:] if last_only else logits

    def check_single(self, what: str) -> None:
        if self.mp > 1 or self.seq_group is not None:
            raise NotImplementedError(
                f"{what} under model or sequence parallelism waits for a "
                "later slice")


def _attr(std: float) -> ParamAttr:
    return ParamAttr(initializer=Normal(std=std))


class _QKVColumn(ColumnParallelLinear):
    """The packed ``[H, 3H]`` qkv: each of the q, k, v thirds split by
    heads over the ranks."""
    split_groups = 3


class _QKVColumnSP(ColumnSequenceParallelLinear):
    split_groups = 3


def _column(pc: ParallelContext):
    return ColumnSequenceParallelLinear if pc.sp else ColumnParallelLinear


def _row(pc: ParallelContext):
    return RowSequenceParallelLinear if pc.sp else RowParallelLinear


class MultiHeadAttention(nn.Module):
    """Causal self-attention with the packed ``[H, 3H]`` qkv projection
    (columns: contiguous q, k, v thirds; under mp each rank's columns are
    its heads of each third)."""

    def __init__(self, c: GPTConfig, *, gen, device, pc=None):
        super().__init__()
        pc = pc or ParallelContext(False, 0, device, gen)
        if c.num_heads % pc.mp:
            raise ValueError(f"num_heads ({c.num_heads}) must be divisible "
                             f"by mp degree ({pc.mp})")
        self.num_heads = c.num_heads // pc.mp
        self.head_dim = c.hidden_size // c.num_heads
        self.attn_drop = c.attention_dropout_prob
        self.gen = pc.local_gen if pc.mp > 1 else gen
        self._pc = pc
        attr = _attr(c.initializer_range)
        kw = dict(generator=gen, device=device)
        self.qkv_proj = (_QKVColumnSP if pc.sp else _QKVColumn)(
            c.hidden_size, 3 * c.hidden_size, weight_attr=attr,
            has_bias=True, gather_output=False, **kw)
        self.out_proj = _row(pc)(c.hidden_size, c.hidden_size,
                                 weight_attr=attr, has_bias=True,
                                 input_is_parallel=True, **kw)

    def forward(self, x, training: bool = True, past=None,
                use_cache: bool = False):
        """``training`` turns attention dropout on (the block passes its
        own mode, as in the JAX package).  ``past``: optional (k, v)
        cache ``[B, S_past, nh, hd]``,
        concatenated before the new keys along seq, or a
        ``PagedLayerView`` (one token per row: append and attend through
        ``paged_attention``); with ``use_cache`` returns ``(out,
        new_past)``."""
        if past is not None:
            _check_kv_pair(past)
        if past is not None or use_cache:
            self._pc.check_single("a KV cache")
        b = x.shape[0]
        hidden = self.num_heads * self.head_dim     # this rank's heads
        qkv = self.qkv_proj(x)
        s = qkv.shape[1]                # the whole sequence under SP
        qkv = qkv.reshape(b, s, 3, self.num_heads, self.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if isinstance(past, PagedLayerView):
            # decode against the page pools (no rope in GPT: positions
            # live in the embeddings)
            if s != 1:
                raise ValueError("paged decode feeds one token per step")
            out = past.append_and_attend(q, k, v).reshape(b, 1, hidden)
            out = self.out_proj(out)
            return (out, past) if use_cache else out
        if past is not None:
            k = torch.cat([past[0], k], dim=1)
            v = torch.cat([past[1], v], dim=1)
        # bottom-right causal alignment: K1's q_offset = sk - sq
        out = F.scaled_dot_product_attention(
            q, k, v, dropout_p=self.attn_drop if training else 0.0,
            is_causal=True, training=training, generator=self.gen)
        out = self.out_proj(out.reshape(b, s, hidden))
        return (out, (k, v)) if use_cache else out


class GPTMLP(nn.Module):
    def __init__(self, c: GPTConfig, *, gen, device, pc=None):
        super().__init__()
        pc = pc or ParallelContext(False, 0, device, gen)
        std = c.initializer_range
        kw = dict(generator=gen, device=device)
        self.fc1 = _column(pc)(c.hidden_size, c.intermediate_size,
                               weight_attr=_attr(std), has_bias=True,
                               gather_output=False, **kw)
        self.fc2 = _row(pc)(c.intermediate_size, c.hidden_size,
                            weight_attr=_attr(
                                std / math.sqrt(2.0 * c.num_layers)),
                            has_bias=True, input_is_parallel=True, **kw)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate=True))


class GPTBlock(nn.Module):
    def __init__(self, c: GPTConfig, *, device, gen, pc=None):
        super().__init__()
        pc = pc or ParallelContext(False, 0, device, gen)
        self.ln1 = LayerNorm(c.hidden_size, device=device)
        self.attn = MultiHeadAttention(c, gen=gen, device=device, pc=pc)
        self.ln2 = LayerNorm(c.hidden_size, device=device)
        self.mlp = GPTMLP(c, gen=gen, device=device, pc=pc)
        self.drop_p = c.hidden_dropout_prob
        self.gen = pc.hidden_gen
        if pc.sp:
            for ln in (self.ln1, self.ln2):
                mark_as_sequence_parallel_parameter(ln.weight)
                mark_as_sequence_parallel_parameter(ln.bias)

    def forward(self, x, past=None, use_cache: bool = False):
        h = self.attn(self.ln1(x), training=self.training, past=past,
                      use_cache=use_cache)
        if use_cache:
            h, new_past = h
        x = x + F.dropout(h, self.drop_p, training=self.training,
                          generator=self.gen)
        h = F.dropout(self.mlp(self.ln2(x)), self.drop_p,
                      training=self.training, generator=self.gen)
        return (x + h, new_past) if use_cache else x + h


class GPTEmbeddings(nn.Module):
    def __init__(self, c: GPTConfig, *, device, gen, pc=None):
        super().__init__()
        pc = pc or ParallelContext(False, 0, device, gen)
        self.word_embeddings = VocabParallelEmbedding(
            c.vocab_size, c.hidden_size,
            weight_attr=_attr(c.initializer_range), generator=gen,
            device=device)
        self.position_embeddings = Embedding(
            c.max_position_embeddings, c.hidden_size,
            std=c.initializer_range, gen=gen, device=device)
        self.drop_p = c.hidden_dropout_prob
        # SP splits after this dropout; sep / cp rows are already a chunk
        self.gen = pc.local_gen if pc.seq_group is not None else gen

    def forward(self, input_ids, pos_offset: int = 0):
        s = input_ids.shape[-1]
        if pos_offset + s > self.position_embeddings.weight.shape[0]:
            raise ValueError(f"sequence position {pos_offset + s} exceeds "
                             "max_position_embeddings "
                             f"{self.position_embeddings.weight.shape[0]}")
        pos = torch.arange(pos_offset, pos_offset + s,
                           device=input_ids.device)
        x = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        return F.dropout(x, self.drop_p, training=self.training,
                         generator=self.gen)


class GPTModel(nn.Module):
    """Transformer decoder stack."""

    def __init__(self, c: GPTConfig, *, device, gen, pc=None):
        super().__init__()
        pc = pc or ParallelContext(False, 0, device, gen)
        self.embeddings = GPTEmbeddings(c, device=device, gen=gen, pc=pc)
        self.layers = nn.ModuleList([
            GPTBlock(c, device=device, gen=gen, pc=pc)
            for _ in range(c.num_layers)])
        self.final_ln = LayerNorm(c.hidden_size, device=device)
        if pc.sp:
            mark_as_sequence_parallel_parameter(self.final_ln.weight)
            mark_as_sequence_parallel_parameter(self.final_ln.bias)
        self.use_recompute = c.use_recompute
        self.gen = gen
        self._pc = pc

    def forward(self, input_ids, past=None, use_cache: bool = False):
        """With ``past`` (one ``(k, v)`` per layer) positions start at
        ``past[0][0].shape[1]``; with paged views at their rows' length,
        which must be one for the batch; with ``use_cache`` returns ``(h,
        new_pasts)``."""
        _check_dense_past(past, len(self.layers))
        if past is not None and isinstance(past[0], PagedLayerView):
            lens = past[0].lengths_np()
            if len(set(lens.tolist())) != 1:
                raise ValueError(
                    "GPT's learned position embedding uses one batch-"
                    "wide offset; paged decode needs uniform lengths")
            pos0 = int(lens[0])
        else:
            pos0 = past[0][0].shape[1] if past is not None else 0
        pc = self._pc
        pos0 += pc.seq_offset(input_ids.shape[-1])
        x = self.embeddings(input_ids, pos_offset=pos0)
        if pc.sp:
            x = ScatterOp.apply(x)
        if use_cache or past is not None:
            new_pasts = []
            for i, block in enumerate(self.layers):
                x = block(x, past=None if past is None else past[i],
                          use_cache=use_cache)
                if use_cache:
                    x, p = x
                    new_pasts.append(p)
            h = self.final_ln(x)
            return (h, new_pasts) if use_cache else h
        for block in self.layers:
            if self.use_recompute and self.training:
                x = recompute(block, x, generator=pc.generators)
            else:
                x = block(x)
        return self.final_ln(x)


def _check_kv_pair(past) -> None:
    """A layer's cache is a dense ``(k, v)`` pair of tensors or a
    ``PagedLayerView``."""
    if isinstance(past, PagedLayerView):
        return
    if not (isinstance(past, (tuple, list)) and len(past) == 2
            and all(isinstance(t, torch.Tensor) for t in past)):
        raise TypeError("past must be a (k, v) pair of tensors or a "
                        "PagedLayerView")


def _check_dense_past(past, n_layers: int) -> None:
    if past is None:
        return
    for p in past:
        _check_kv_pair(p)
    if len(past) != n_layers:
        raise ValueError(f"past has {len(past)} layers, the model "
                         f"{n_layers}")


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
    generator, past the initializers, draws the dropout bits.  Under the
    fleet topology's mp / sep / cp degrees the model is built split
    (module docstring); ``sequence_parallel=True`` is Megatron SP there
    and changes nothing at one rank."""

    supports_paged_cache = True   # attention dispatches on PagedLayerView

    def __init__(self, config: GPTConfig, *, device=None, seed: int = 0):
        super().__init__()
        dev = default_device(device)
        gen = generator(seed, dev)
        self.config = config
        self._pc = pc = ParallelContext(config.sequence_parallel, seed, dev,
                                        gen)
        self.gpt = GPTModel(config, device=dev, gen=gen, pc=pc)
        if not config.tie_word_embeddings:
            self.lm_head_weight = nn.Parameter(torch.empty(
                config.vocab_size, config.hidden_size, device=dev,
                dtype=torch.float32))
            with torch.no_grad():
                self.lm_head_weight.normal_(0.0, config.initializer_range,
                                            generator=gen)
        self.loss_fn = GPTPretrainingCriterion()
        if pc.sp:
            register_sequence_parallel_allreduce_hooks(self)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.gpt.final_ln.weight.device

    def lm_weight(self):
        return self.gpt.embeddings.word_embeddings.weight \
            if self.config.tie_word_embeddings else self.lm_head_weight

    @property
    def generator(self) -> torch.Generator:
        """The model's ``torch.Generator`` (initializers, then dropout, then
        sampling in ``generate``)."""
        return self.gpt.gen

    def forward(self, input_ids, past=None, use_cache: bool = False,
                last_logits_only: bool = False):
        """Dense forward: ``input_ids [B, S]`` -> ``logits [B, S, V]``
        (``[B, 1, V]`` with ``last_logits_only``); under ``torch.no_grad``
        in eval mode.  ``past`` (one ``(k, v)`` ``[B, S_past, nh, hd]``
        per layer) is concatenated before the new keys and positions start
        at ``S_past``; ``use_cache`` returns ``(logits, new_past)``."""
        with torch.set_grad_enabled(self.training
                                    and torch.is_grad_enabled()):
            h = self.gpt(input_ids, past=past, use_cache=use_cache)
            if use_cache:
                h, new_past = h
            # under mp: this rank's vocabulary columns of the logits
            logits = self._pc.head(h, self.lm_weight(), last_logits_only)
            return (logits, new_past) if use_cache else logits

    def generate(self, input_ids, **kwargs):
        """KV-cache decode; see ``models.generation.generate``."""
        from .generation import generate
        return generate(self, input_ids, **kwargs)

    def build_decode_step(self):
        """The compiled decode loop's per-token body over fixed-shape
        caches; see :func:`_build_gpt_decode_step`."""
        self._pc.check_single("the compiled decode step")
        return _build_gpt_decode_step(self)

    def build_ragged_decode_step(self):
        """Batched serving-engine step over paged KV pools; see
        ``models.generation.build_ragged_decode_step``."""
        self._pc.check_single("the ragged decode step")
        from .generation import build_ragged_decode_step
        return build_ragged_decode_step(self)

    def build_fused_window_step(self, max_window: int):
        """The serving window: up to ``max_window`` ragged decode
        iterations with one host read; see
        ``models.generation.build_fused_window_step``."""
        self._pc.check_single("the fused serving window")
        from .generation import build_fused_window_step
        return build_fused_window_step(self, max_window)


def _build_gpt_decode_step(model: GPTForPretraining):
    """``(params, step)`` with ``step(params, tok [B], caches, pos) ->
    (logits [B, V], caches)`` over preallocated ``[B, S_total, nh, hd]``
    caches (one ``(k, v)`` per layer, updated in place at the host int
    ``pos``): LayerNorm, K6a (no rope: positions live in the embedding),
    K6b, the output projection and K6c per layer.  ``params`` are views
    of the model's parameters in the JAX step's layout: q/k/v weights and
    biases are column slices of the packed ``qkv_proj``."""
    c = model.config
    gpt = model.gpt
    hidden, nh = c.hidden_size, c.num_heads
    hd = hidden // nh
    blocks = []
    for blk in gpt.layers:
        w, b = blk.attn.qkv_proj.weight, blk.attn.qkv_proj.bias
        blocks.append({
            "ln1_w": blk.ln1.weight, "ln1_b": blk.ln1.bias,
            "wq": w[:, :hidden], "wk": w[:, hidden:2 * hidden],
            "wv": w[:, 2 * hidden:], "bq": b[:hidden],
            "bk": b[hidden:2 * hidden], "bv": b[2 * hidden:],
            "wo": blk.attn.out_proj.weight, "bo": blk.attn.out_proj.bias,
            "ln2_w": blk.ln2.weight, "ln2_b": blk.ln2.bias,
            "w1": blk.mlp.fc1.weight, "b1": blk.mlp.fc1.bias,
            "w2": blk.mlp.fc2.weight, "b2": blk.mlp.fc2.bias,
        })
    params = {"wte": gpt.embeddings.word_embeddings.weight,
              "wpe": gpt.embeddings.position_embeddings.weight,
              "blocks": blocks, "lnf_w": gpt.final_ln.weight,
              "lnf_b": gpt.final_ln.bias, "lm_w": model.lm_weight()}

    @torch.no_grad()
    def step(p, tok, caches, pos: int):
        x = p["wte"][tok] + p["wpe"][pos]
        for i, bp in enumerate(p["blocks"]):
            h = _fd.reference_layer_norm(x, bp["ln1_w"], bp["ln1_b"], 1e-5)
            q, k, v = _fd.rope_qkv(h, bp["wq"], bp["wk"], bp["wv"], bp["bq"],
                                   bp["bk"], bp["bv"], n_heads=nh, n_kv=nh,
                                   head_dim=hd)
            ctx, _, _ = _fd.attend_cache_append(q, k, v, caches[i][0],
                                                caches[i][1], pos)
            x = x + (torch.matmul(ctx.reshape(-1, hidden), bp["wo"])
                     + bp["bo"])
            x = x + _fd.norm_mlp(x, kind="layer_norm", norm_w=bp["ln2_w"],
                                 norm_b=bp["ln2_b"], w1=bp["w1"],
                                 b1=bp["b1"], w2=bp["w2"], b2=bp["b2"],
                                 eps=1e-5, act="gelu_tanh")
        h = _fd.reference_layer_norm(x, p["lnf_w"], p["lnf_b"], 1e-5)
        return torch.matmul(h, p["lm_w"].transpose(0, 1)), caches

    return params, step


class GPTPretrainingCriterion(nn.Module):
    """Next-token cross entropy, the mean over valid tokens only
    (``labels != -100``): the JAX criterion's masked sum over the mask
    count.  Each op casts its inputs by the amp rule, as the JAX ops do
    under O2 (the product and the clip run in the low dtype, the sums in
    fp32, so the O2 loss comes out in the low dtype).  The per-token
    loss is ``ParallelCrossEntropy``'s: over vocab-split logits under
    mp; at one rank ``_vocab_sharded`` keeps it off the softmax-CE
    kernel K8, as in the JAX package.  Under a sep / cp axis (read when
    the criterion is built) the masked sum and the count are summed over
    that group before the division (backward: each rank's own tokens)."""

    ignore_index = -100

    def __init__(self):
        super().__init__()
        self.ce = ParallelCrossEntropy(ignore_index=self.ignore_index)
        self._seq_group = segment_parallel.seq_parallel_group()

    def _seq_sum(self, t):
        if self._seq_group is None:
            return t
        t = t.clone()
        all_reduce(t, group=self._seq_group)
        return t

    def forward(self, logits, labels):
        b, s, v = logits.shape
        flat = labels.reshape(b * s)
        loss = self.ce(logits.reshape(b * s, v), flat)
        mask = (flat != self.ignore_index).to(loss.dtype)
        loss, mask = amp.cast("multiply", loss, mask)
        (num,) = amp.cast("sum", loss * mask)
        (den,) = amp.cast("sum", mask)
        num, den = self._seq_sum(num.sum()), self._seq_sum(den.sum())
        (den,) = amp.cast("clip", den)
        num, den = amp.cast("divide", num, den.clamp(min=1.0))
        return num / den
