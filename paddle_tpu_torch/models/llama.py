"""LLaMA model family; counterpart of ``paddle_tpu/models/llama.py``.

Parameters keep the JAX package's ``state_dict`` names and ``[in, out]``
weight layout (``llama.layers.{i}.self_attn.q_proj.weight [H, nh·hd]``,
``llama.embed_tokens.weight [V, H]``, ``lm_head_weight [V, H]``, ...), so
weights carry over without transposes (``models.carry``).

The dense forward: RMSNorm through
``incubate.nn.functional.fused_rms_norm`` (K4a/K4b on CUDA), q and k
rotated through ``fused_rotary_position_embedding`` (K5, interleaved),
causal attention with un-broadcast GQA kv heads through
``nn.functional.scaled_dot_product_attention`` (K1), and the SwiGLU MLP
(``silu``, or ``gelu_tanh`` for Gemma-style configs).  Every op reads the
amp state.  ``use_recompute`` recomputes each decoder layer in the
backward (``fleet.recompute``).  With a KV cache (``past``,
``use_cache``) the rope tables are sliced at the cache's length and K1
aligns the causal mask bottom-right; ``last_logits_only`` runs the head
on the last position only.  :meth:`LlamaForCausalLM.build_decode_step`
is the compiled decode loop's per-token body over fixed-shape caches, on
the fused decode kernels K6a/K6b/K6c (``ops.fused_decode``), with the
JAX step's RMSNorm numerics; ``generate`` is
``models.generation.generate``.

With a paged cache (one ``PagedLayerView`` per layer, from eager paged
``generate``) each row is rotated at its own length through ``[B, 1,
D]`` tables and attends through ``ops.paged_attention`` (K9's
counterpart on CUDA).  :meth:`LlamaForCausalLM.build_ragged_decode_step`
and :meth:`~LlamaForCausalLM.build_fused_window_step` are the serving
engine's step and window (``models.generation``).

Under the fleet topology's mp degree the layers are tensor-parallel, as
in the JAX package: q / k / v / gate / up column-parallel (q / k / v,
and gate / up, one input's products in one function,
``mp_layers.column_linear``), o / down row-parallel, ``embed_tokens``
vocab-parallel and ``lm_head_weight [V, H]`` split by vocabulary rows
into ``ParallelCrossEntropy``.  Every rank draws the one-rank model's
weights in its order and keeps its shards.  ``sequence_parallel=True``
is Megatron SP (K4a/K4b and the residual adds run on the rank's
sequence chunk; the RMSNorm weights are marked and their gradients
summed over mp by hooks); under a sep / cp axis each rank holds its
chunk and the rope tables are sliced at its global positions (see
``models.gpt`` for both).  GQA with ``num_key_value_heads`` not
divisible by mp would split a kv head over ranks: it raises
``NotImplementedError``.  The KV-cache and decode paths run at one rank
only.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..device import default_device, generator
from ..distributed.fleet.recompute import recompute
from ..incubate.nn.functional import (fused_rms_norm,
                                      fused_rotary_position_embedding)
from ..nn import functional as F
from ..ops import fused_decode as _fd
from ..ops.paged_attention import PagedLayerView
from ..distributed.fleet.meta_parallel.parallel_layers.mp_layers import (
    VocabParallelEmbedding, shard_of)
from ..distributed.fleet.utils.sequence_parallel_utils import (
    ScatterOp, mark_as_sequence_parallel_parameter,
    register_sequence_parallel_allreduce_hooks)
from .gpt import (GPTPretrainingCriterion, ParallelContext, _attr, _column,
                  _row, _check_dense_past, _check_kv_pair)

__all__ = ["LlamaConfig", "LLAMA_PRESETS", "llama_config", "LlamaModel",
           "LlamaForCausalLM", "LlamaPretrainingCriterion",
           "llama_pipeline_step"]

@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: Optional[int] = None       # None -> MHA
    intermediate_size: Optional[int] = None  # None -> SwiGLU 8/3 rule
    max_position_embeddings: int = 4096
    rms_eps: float = 1e-5
    rope_theta: float = 10000.0
    attention_bias: bool = False     # qkv biases (Qwen2-style)
    initializer_range: float = 0.02
    use_recompute: bool = False
    sequence_parallel: bool = False
    hidden_act: str = "silu"          # "silu" | "gelu_tanh" (Gemma)
    embed_scale: float = 1.0          # Gemma multiplies by sqrt(hidden)
    tie_word_embeddings: bool = False

    def __post_init__(self):
        if self.hidden_act not in ("silu", "gelu_tanh"):
            raise ValueError(
                f"hidden_act={self.hidden_act!r} is not supported "
                "('silu' or 'gelu_tanh'); HF 'gelu_pytorch_tanh' maps "
                "to 'gelu_tanh'")
        if self.num_kv_heads is None:
            self.num_kv_heads = self.num_heads
        if self.intermediate_size is None:
            # llama rule: 2/3 * 4h rounded up to a multiple of 256
            inter = int(8 * self.hidden_size / 3)
            self.intermediate_size = 256 * ((inter + 255) // 256)


LLAMA_PRESETS = {
    "llama2-7b": dict(num_layers=32, hidden_size=4096, num_heads=32,
                      intermediate_size=11008),
    "llama2-13b": dict(num_layers=40, hidden_size=5120, num_heads=40,
                       intermediate_size=13824),
    "llama2-70b": dict(num_layers=80, hidden_size=8192, num_heads=64,
                       num_kv_heads=8, intermediate_size=28672),
    "tiny": dict(num_layers=2, hidden_size=64, num_heads=4,
                 num_kv_heads=2, vocab_size=256,
                 max_position_embeddings=128),
}


def llama_config(name: str, **overrides) -> LlamaConfig:
    cfg = dict(LLAMA_PRESETS[name])
    cfg.update(overrides)
    return LlamaConfig(**cfg)


def _rope_cache(head_dim: int, max_pos: int, theta: float):
    """Full-width [S, head_dim] cos/sin (each pair's angle duplicated),
    the layout ``fused_rotary_position_embedding`` consumes."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype="float32")
                           / head_dim))
    t = np.arange(max_pos, dtype="float32")
    freqs = np.outer(t, inv)                       # [S, hd/2]
    full = np.repeat(freqs, 2, axis=-1)            # [S, hd]
    return np.cos(full), np.sin(full)


class LlamaRMSNorm(nn.Module):
    """RMSNorm with a unit-initialised fp32 weight, kept fp32 under O2
    (``amp.decorate`` skips layers named ``*RMSNorm``)."""

    def __init__(self, hidden_size: int, epsilon: float = 1e-5, *, device):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(hidden_size, device=device,
                                              dtype=torch.float32))
        self.epsilon = epsilon

    def forward(self, x):
        out, _ = fused_rms_norm(x, self.weight, epsilon=self.epsilon)
        return out


class LlamaAttention(nn.Module):
    """Rotary GQA attention (training forward, no KV cache); under mp
    this rank's q heads and kv heads."""

    def __init__(self, c: LlamaConfig, *, gen, device, pc=None):
        super().__init__()
        pc = pc or ParallelContext(False, 0, device, gen)
        if c.num_heads % pc.mp:
            raise ValueError(f"num_heads ({c.num_heads}) must be divisible "
                             f"by mp degree ({pc.mp})")
        if c.num_kv_heads % pc.mp:
            raise NotImplementedError(
                f"num_key_value_heads ({c.num_kv_heads}) not divisible by "
                f"mp degree ({pc.mp}) would split a kv head over ranks")
        self.num_heads = c.num_heads // pc.mp
        self.num_kv = c.num_kv_heads // pc.mp
        self.head_dim = c.hidden_size // c.num_heads
        self._pc = pc
        attr = _attr(c.initializer_range)
        kw = dict(generator=gen, device=device)
        qkv_bias = bool(c.attention_bias)
        col, row = _column(pc), _row(pc)
        hd = self.head_dim
        self.q_proj = col(c.hidden_size, c.num_heads * hd, weight_attr=attr,
                          has_bias=qkv_bias, gather_output=False, **kw)
        self.k_proj = col(c.hidden_size, c.num_kv_heads * hd,
                          weight_attr=attr, has_bias=qkv_bias,
                          gather_output=False, **kw)
        self.v_proj = col(c.hidden_size, c.num_kv_heads * hd,
                          weight_attr=attr, has_bias=qkv_bias,
                          gather_output=False, **kw)
        self.o_proj = row(c.num_heads * hd, c.hidden_size, weight_attr=attr,
                          has_bias=False, input_is_parallel=True, **kw)
        cos, sin = _rope_cache(self.head_dim, c.max_position_embeddings,
                               c.rope_theta)
        # position constants: not parameters, not in the state_dict
        self.register_buffer("_cos", torch.from_numpy(cos).to(device),
                             persistent=False)
        self.register_buffer("_sin", torch.from_numpy(sin).to(device),
                             persistent=False)

    def forward(self, x, past=None, use_cache: bool = False):
        """``past``: optional (k, v) cache ``[B, S_past, nkv, hd]`` (kv
        heads un-broadcast), concatenated before the new keys along seq;
        positions start at ``S_past``.  Or a ``PagedLayerView``: one token
        per row, at each row's own position.  With ``use_cache`` returns
        ``(out, new_past)``."""
        if past is not None:
            _check_kv_pair(past)
        pc = self._pc
        if past is not None or use_cache:
            pc.check_single("a KV cache")
        if isinstance(past, PagedLayerView):
            return self._paged(x, past, use_cache)
        # one input for q / k / v (the whole sequence under SP)
        q, k, v = pc.column(x, (self.q_proj, self.k_proj, self.v_proj))
        b, s = q.shape[:2]
        pos0 = past[0].shape[1] if past is not None else pc.seq_offset(s)
        if pos0 + s > self._cos.shape[0]:
            raise ValueError(
                f"sequence position {pos0 + s} exceeds "
                f"max_position_embeddings {self._cos.shape[0]}: the rope "
                "table has no entries past that point")
        q = q.reshape(b, s, self.num_heads, self.head_dim)
        k = k.reshape(b, s, self.num_kv, self.head_dim)
        v = v.reshape(b, s, self.num_kv, self.head_dim)
        q, k, _ = fused_rotary_position_embedding(
            q, k, sin=self._sin[pos0:pos0 + s], cos=self._cos[pos0:pos0 + s],
            use_neox_rotary_style=False)
        if past is not None:
            k = torch.cat([past[0], k], dim=1)
            v = torch.cat([past[1], v], dim=1)
        # GQA kv heads stay un-broadcast: K1 reads kv head i // n_rep, with
        # bottom-right causal alignment (q_offset = sk - sq)
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                             training=self.training)
        out = self.o_proj(out.reshape(b, s, self.num_heads * self.head_dim))
        return (out, (k, v)) if use_cache else out

    def _paged(self, x, past, use_cache: bool):
        """One token per row against the page pools: each row rotated at
        its own position (its length), appended to the pages, attended
        through ``paged_attention``."""
        b, s, _ = x.shape
        if s != 1:
            raise ValueError("paged decode feeds one token per step")
        top = int(past.lengths_np().max()) + 1
        if top > self._cos.shape[0]:
            raise ValueError(f"sequence position {top} exceeds "
                             f"max_position_embeddings {self._cos.shape[0]}")
        q = self.q_proj(x).reshape(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(x).reshape(b, s, self.num_kv, self.head_dim)
        v = self.v_proj(x).reshape(b, s, self.num_kv, self.head_dim)
        # [B, 1, D] tables, one row per sequence at its length: the cache's
        # lengths on the device, which the last step's attention copied
        pos, _ = past.cache.batch_tables(past.seq_ids)
        cos = self._cos.index_select(0, pos)[:, None]
        sin = self._sin.index_select(0, pos)[:, None]
        q, k, _ = fused_rotary_position_embedding(
            q, k, sin=sin, cos=cos, use_neox_rotary_style=False)
        out = past.append_and_attend(q, k, v)             # [B, nh, hd]
        out = self.o_proj(out.reshape(b, 1, self.num_heads * self.head_dim))
        return (out, past) if use_cache else out


class LlamaMLP(nn.Module):
    """SwiGLU: ``down(act(gate(x)) * up(x))``."""

    def __init__(self, c: LlamaConfig, *, gen, device, pc=None):
        super().__init__()
        pc = pc or ParallelContext(False, 0, device, gen)
        kw = dict(weight_attr=_attr(c.initializer_range), has_bias=False,
                  generator=gen, device=device)
        self.gate_proj = _column(pc)(c.hidden_size, c.intermediate_size,
                                     gather_output=False, **kw)
        self.up_proj = _column(pc)(c.hidden_size, c.intermediate_size,
                                   gather_output=False, **kw)
        self.down_proj = _row(pc)(c.intermediate_size, c.hidden_size,
                                  input_is_parallel=True, **kw)
        self.act = c.hidden_act
        self._pc = pc

    def forward(self, x):
        g, u = self._pc.column(x, (self.gate_proj, self.up_proj))
        a = F.gelu(g, approximate=True) if self.act == "gelu_tanh" \
            else F.silu(g)
        return self.down_proj(a * u)


class LlamaDecoderLayer(nn.Module):
    def __init__(self, c: LlamaConfig, *, gen, device, pc=None):
        super().__init__()
        pc = pc or ParallelContext(False, 0, device, gen)
        self.input_layernorm = LlamaRMSNorm(c.hidden_size, c.rms_eps,
                                            device=device)
        self.self_attn = LlamaAttention(c, gen=gen, device=device, pc=pc)
        self.post_attention_layernorm = LlamaRMSNorm(
            c.hidden_size, c.rms_eps, device=device)
        self.mlp = LlamaMLP(c, gen=gen, device=device, pc=pc)
        if pc.sp:
            mark_as_sequence_parallel_parameter(self.input_layernorm.weight)
            mark_as_sequence_parallel_parameter(
                self.post_attention_layernorm.weight)

    def forward(self, x, past=None, use_cache: bool = False):
        h = self.self_attn(self.input_layernorm(x), past=past,
                           use_cache=use_cache)
        if use_cache:
            h, new_past = h
        x = x + h
        x = x + self.mlp(self.post_attention_layernorm(x))
        return (x, new_past) if use_cache else x


class LlamaModel(nn.Module):
    def __init__(self, c: LlamaConfig, *, gen, device, pc=None):
        super().__init__()
        pc = pc or ParallelContext(False, 0, device, gen)
        self.config = c
        self.embed_tokens = VocabParallelEmbedding(
            c.vocab_size, c.hidden_size,
            weight_attr=_attr(c.initializer_range), generator=gen,
            device=device)
        self.layers = nn.ModuleList([
            LlamaDecoderLayer(c, gen=gen, device=device, pc=pc)
            for _ in range(c.num_layers)])
        self.norm = LlamaRMSNorm(c.hidden_size, c.rms_eps, device=device)
        if pc.sp:
            mark_as_sequence_parallel_parameter(self.norm.weight)
        self.gen = gen
        self._pc = pc

    def forward(self, input_ids, past=None, use_cache: bool = False):
        c = self.config
        _check_dense_past(past, len(self.layers))
        x = self.embed_tokens(input_ids)
        if c.embed_scale != 1.0:
            x = x * c.embed_scale
        if self._pc.sp:
            x = ScatterOp.apply(x)
        if use_cache or past is not None:
            # a given cache is consumed even without use_cache: dropping
            # it would score the tokens with no history
            new_pasts = []
            for i, layer in enumerate(self.layers):
                x = layer(x, past=None if past is None else past[i],
                          use_cache=use_cache)
                if use_cache:
                    x, p = x
                    new_pasts.append(p)
            h = self.norm(x)
            return (h, new_pasts) if use_cache else h
        for layer in self.layers:
            if c.use_recompute and self.training:
                x = recompute(layer, x, generator=self._pc.generators)
            else:
                x = layer(x)
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    """LLaMA with its own ``lm_head_weight [V, H]`` (or the embedding,
    tied).

    ``device=None`` means the CUDA card and raises without one; pass
    ``device="cpu"`` for the CPU.  Weights are fp32, drawn from a
    ``torch.Generator`` seeded with ``seed`` on that device: Normal(0,
    0.02) for the embedding, every projection and the head, unit RMSNorm
    weights — the JAX package's initializers (its random bits differ;
    carry weights over with ``models.carry.load_paddle_tpu_state`` to
    compare).  A new model is in eval mode; ``jit.train_step`` sets
    training mode.  Under the fleet topology's mp / sep / cp degrees the
    model is built split (module docstring)."""

    supports_paged_cache = True   # attention dispatches on PagedLayerView

    def __init__(self, config: LlamaConfig, *, device=None, seed: int = 0):
        super().__init__()
        dev = default_device(device)
        gen = generator(seed, dev)
        self.config = config
        self._pc = pc = ParallelContext(config.sequence_parallel, seed, dev,
                                        gen)
        self.llama = LlamaModel(config, gen=gen, device=dev, pc=pc)
        if not config.tie_word_embeddings:
            full = torch.empty(config.vocab_size, config.hidden_size,
                               device=dev, dtype=torch.float32)
            with torch.no_grad():
                full.normal_(0.0, config.initializer_range, generator=gen)
            if pc.mp > 1:
                if config.vocab_size % pc.mp:
                    raise ValueError(f"vocab_size ({config.vocab_size}) must "
                                     f"be divisible by mp degree ({pc.mp})")
                full = shard_of(full, 0, 1, pc.mp_rank, pc.mp).contiguous()
            self.lm_head_weight = nn.Parameter(full)
            self.lm_head_weight.split_axis = 0
            self.lm_head_weight.split_groups = 1
        self.loss_fn = LlamaPretrainingCriterion()
        if pc.sp:
            register_sequence_parallel_allreduce_hooks(self)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.llama.norm.weight.device

    def lm_weight(self):
        return self.llama.embed_tokens.weight \
            if self.config.tie_word_embeddings else self.lm_head_weight

    @property
    def generator(self) -> torch.Generator:
        """The model's ``torch.Generator`` (initializers, then sampling in
        ``generate``)."""
        return self.llama.gen

    def forward(self, input_ids, past=None, use_cache: bool = False,
                last_logits_only: bool = False):
        """Dense forward: ``input_ids [B, S]`` -> ``logits [B, S, V]``
        (``[B, 1, V]`` with ``last_logits_only``); under ``torch.no_grad``
        in eval mode.  ``past`` (one ``(k, v)`` ``[B, S_past, nkv, hd]``
        per layer) is concatenated before the new keys and the rope tables
        are sliced at ``S_past``; ``use_cache`` returns ``(logits,
        new_past)``."""
        with torch.set_grad_enabled(self.training
                                    and torch.is_grad_enabled()):
            h = self.llama(input_ids, past=past, use_cache=use_cache)
            if use_cache:
                h, new_past = h
            # under mp: this rank's vocabulary columns of the logits;
            # decode samples only the last position (one rank: the [S, V]
            # head skipped for the rest of the prompt)
            logits = self._pc.head(h, self.lm_weight(), last_logits_only)
            return (logits, new_past) if use_cache else logits

    def generate(self, input_ids, **kwargs):
        """KV-cache decode; see ``models.generation.generate``."""
        from .generation import generate
        return generate(self, input_ids, **kwargs)

    def build_decode_step(self):
        """The compiled decode loop's per-token body over fixed-shape
        caches; see :func:`_build_llama_decode_step`."""
        self._pc.check_single("the compiled decode step")
        return _build_llama_decode_step(self)

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


def _build_llama_decode_step(model: LlamaForCausalLM):
    """``(params, step)`` with ``step(params, tok [B], caches, pos) ->
    (logits [B, V], caches)`` over preallocated ``[B, S_total, nkv, hd]``
    caches (one ``(k, v)`` per layer, updated in place at the host int
    ``pos``): RMSNorm, K6a with the rope row at ``pos`` (interleaved),
    K6b (GQA inside the kernel), the output projection and K6c (RMSNorm +
    SwiGLU) per layer.  ``params`` are views of the model's parameters in
    the JAX step's layout; a tied head reads the embedding."""
    c = model.config
    llama = model.llama
    nh, nkv = c.num_heads, c.num_kv_heads
    hd = c.hidden_size // nh
    eps, scale, act = float(c.rms_eps), float(c.embed_scale), c.hidden_act
    layers = []
    for lyr in llama.layers:
        att, mlp = lyr.self_attn, lyr.mlp
        layers.append({
            "ln1_w": lyr.input_layernorm.weight,
            "wq": att.q_proj.weight, "wk": att.k_proj.weight,
            "wv": att.v_proj.weight, "bq": att.q_proj.bias,
            "bk": att.k_proj.bias, "bv": att.v_proj.bias,
            "wo": att.o_proj.weight,
            "ln2_w": lyr.post_attention_layernorm.weight,
            "wg": mlp.gate_proj.weight, "wu": mlp.up_proj.weight,
            "wd": mlp.down_proj.weight,
        })
    # the rope tables are the same in every layer (one config)
    att0 = llama.layers[0].self_attn
    params = {"embed": llama.embed_tokens.weight, "cos": att0._cos,
              "sin": att0._sin, "layers": layers,
              "norm_w": llama.norm.weight, "lm_w": model.lm_weight()}

    @torch.no_grad()
    def step(p, tok, caches, pos: int):
        x = p["embed"][tok]
        if scale != 1.0:
            x = x * scale
        cos_row, sin_row = p["cos"][pos], p["sin"][pos]
        for i, lp in enumerate(p["layers"]):
            h = _fd.reference_rms_norm(x, lp["ln1_w"], eps)
            q, k, v = _fd.rope_qkv(h, lp["wq"], lp["wk"], lp["wv"], lp["bq"],
                                   lp["bk"], lp["bv"], cos_row, sin_row,
                                   n_heads=nh, n_kv=nkv, head_dim=hd,
                                   neox=False)
            ctx, _, _ = _fd.attend_cache_append(q, k, v, caches[i][0],
                                                caches[i][1], pos)
            x = x + torch.matmul(ctx.reshape(-1, nh * hd), lp["wo"])
            x = x + _fd.norm_mlp(x, kind="rms_norm", norm_w=lp["ln2_w"],
                                 w_gate=lp["wg"], w1=lp["wu"], w2=lp["wd"],
                                 eps=eps, act=act)
        h = _fd.reference_rms_norm(x, p["norm_w"], eps)
        return torch.matmul(h, p["lm_w"].transpose(0, 1)), caches

    return params, step


def llama_pipeline_step(model: LlamaForCausalLM, optimizer, mesh,
                        n_micro: int, axis_name: str = "pp",
                        dp_axes=("dp", "sharding"),
                        remat_blocks: bool = True, n_chunks: int = 1,
                        scaler=None, autocast=None):
    """The pipeline step of a LLaMA built under the fleet topology
    (``pp_spmd.make_transformer_pipeline_step``): pre = the token
    embedding (times ``embed_scale``), blocks = the decoder layers, post
    = a plain RMSNorm in fp32 (not K4a: the JAX package's ``post_fn``
    computes it with jnp), the head (vocab-split under mp) and fp32 cross
    entropy; a tied head shares the embedding across the first and last
    stage."""
    from ..distributed.fleet.meta_parallel.pp_spmd import (
        _tie_across_stages, fp32_cross_entropy,
        make_transformer_pipeline_step)
    llama = model.llama
    cfg = model.config
    emb_w = llama.embed_tokens.weight
    norm_w = llama.norm.weight
    rep_tensors = [emb_w, norm_w] + (
        [] if cfg.tie_word_embeddings else [model.lm_head_weight])
    pc = model._pc

    def pre_fn(rep_v, ids):
        h = llama.embed_tokens(ids)
        if cfg.embed_scale != 1.0:      # Gemma's sqrt(hidden) scaling
            h = h * cfg.embed_scale
        return h

    def post_fn(rep_v, h, labels):
        nw = rep_v[1]
        hw = rep_v[0] if cfg.tie_word_embeddings else rep_v[2]
        hf = h.float()
        var = (hf * hf).mean(-1, keepdim=True)
        hn = hf * torch.rsqrt(var + cfg.rms_eps) * nw
        return fp32_cross_entropy(pc.head(hn, hw), labels)

    step = make_transformer_pipeline_step(
        llama.layers, rep_tensors, pre_fn, post_fn, optimizer, mesh,
        n_micro, axis_name=axis_name, dp_axes=dp_axes,
        remat_blocks=remat_blocks, n_chunks=n_chunks,
        stack_prefix="llama_pp_stack", scaler=scaler, autocast=autocast)
    if cfg.tie_word_embeddings:
        _tie_across_stages([emb_w], step.hcg)
    return step


class LlamaPretrainingCriterion(GPTPretrainingCriterion):
    """Next-token cross entropy, the mean over valid tokens: the JAX
    LLaMA criterion is the GPT one, formula and amp casts alike."""
