"""BART encoder-decoder family; counterpart of ``paddle_tpu/models/bart.py``.

Post-LayerNorm stacks, learned positions offset by 2, scaled attention
with biased projections, the shared token embedding as the tied head and
the frozen ``final_logits_bias``.  Parameters keep the JAX package's
``state_dict`` names and ``[in, out]`` weight layout
(``encoder.layers.{i}.self_attn.q_proj.weight [d, d]``,
``shared.weight [V, d]``, ...), so weights carry over without transposes
(``models.carry``); the shared embedding appears once, as
``shared.weight``.

Attention is plain matmuls with additive masks, as in the JAX model: a
padded key adds ``-1e9``, and decoder self-attention adds the ``-1e9``
upper triangle (``np.triu(..., k=Sk-Sq+1)``), so a padded causal slot
carries ``-2e9`` in both packages.  LayerNorm goes through
``nn.functional.layer_norm`` (K2 on CUDA) and ``loss_fn`` through
``nn.functional.cross_entropy`` with ``reduction="mean"`` (the softmax-CE
kernel K8 on CUDA).  ``generate`` is ``models.generation.seq2seq_generate``
over a full decoder forward per token, as in the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..device import default_device, generator
from ..nn import functional as F
from ..nn.initializer import Normal, ParamAttr
from ..nn.layers import Linear
from .gpt import Embedding, LayerNorm

__all__ = ["BartConfig", "BartForConditionalGeneration"]

_POS_OFFSET = 2        # HF BartLearnedPositionalEmbedding offset
_INIT_STD = 0.02       # HF BartConfig.init_std


def _linear(n_in: int, n_out: int, *, gen, device) -> Linear:
    """A Paddle ``[in, out]`` ``Linear`` drawn Normal(0, init_std) from
    ``gen``, its bias zeros."""
    return Linear(n_in, n_out,
                  weight_attr=ParamAttr(initializer=Normal(0.0, _INIT_STD)),
                  generator=gen, device=device)


@dataclass
class BartConfig:
    vocab_size: int = 50265
    d_model: int = 768
    encoder_layers: int = 6
    decoder_layers: int = 6
    encoder_attention_heads: int = 12
    decoder_attention_heads: int = 12
    encoder_ffn_dim: int = 3072
    decoder_ffn_dim: int = 3072
    max_position_embeddings: int = 1024
    activation_function: str = "gelu"
    scale_embedding: bool = False
    pad_token_id: int = 1
    eos_token_id: int = 2
    decoder_start_token_id: int = 2
    forced_eos_token_id: Optional[int] = 2


class _BartAttention(nn.Module):
    def __init__(self, d_model: int, n_heads: int, causal: bool, *, gen,
                 device):
        super().__init__()
        kw = dict(gen=gen, device=device)
        self.q_proj = _linear(d_model, d_model, **kw)
        self.k_proj = _linear(d_model, d_model, **kw)
        self.v_proj = _linear(d_model, d_model, **kw)
        self.out_proj = _linear(d_model, d_model, **kw)
        self.h = n_heads
        self.dk = d_model // n_heads
        self.causal = causal

    def forward(self, x, kv=None, key_mask=None):
        b, sq = x.shape[0], x.shape[1]
        mem = x if kv is None else kv
        sk = mem.shape[1]
        h, dk = self.h, self.dk
        q = self.q_proj(x).reshape(b, sq, h, dk).transpose(1, 2)
        k = self.k_proj(mem).reshape(b, sk, h, dk).transpose(1, 2)
        v = self.v_proj(mem).reshape(b, sk, h, dk).transpose(1, 2)
        scores = F.matmul(q, k, transpose_y=True) * (dk ** -0.5)
        if key_mask is not None:
            neg = (1.0 - key_mask.float()) * -1e9
            scores = scores + neg.reshape(b, 1, 1, sk)
        if self.causal and kv is None:
            mask = torch.full((sq, sk), -1e9, dtype=torch.float32,
                              device=x.device).triu(sk - sq + 1)
            scores = scores + mask
        probs = F.softmax(scores, axis=-1)
        ctx = F.matmul(probs, v).transpose(1, 2).reshape(b, sq, h * dk)
        return self.out_proj(ctx)


class _BartLayer(nn.Module):
    """POST-layernorm block: LN(residual + sublayer(x))."""

    def __init__(self, c: BartConfig, is_decoder: bool, *, gen, device):
        super().__init__()
        d = c.d_model
        heads = (c.decoder_attention_heads if is_decoder
                 else c.encoder_attention_heads)
        ffn = c.decoder_ffn_dim if is_decoder else c.encoder_ffn_dim
        kw = dict(gen=gen, device=device)
        self.is_decoder = is_decoder
        self.self_attn = _BartAttention(d, heads, causal=is_decoder, **kw)
        self.self_attn_layer_norm = LayerNorm(d, device=device)
        if is_decoder:
            self.encoder_attn = _BartAttention(d, heads, causal=False, **kw)
            self.encoder_attn_layer_norm = LayerNorm(d, device=device)
        self.fc1 = _linear(d, ffn, **kw)
        self.fc2 = _linear(ffn, d, **kw)
        self.final_layer_norm = LayerNorm(d, device=device)
        acts = {"gelu": F.gelu, "relu": F.relu, "silu": F.silu,
                "gelu_new": lambda x: F.gelu(x, approximate=True),
                "gelu_fast": lambda x: F.gelu(x, approximate=True)}
        if c.activation_function not in acts:
            raise ValueError(
                f"activation_function={c.activation_function!r} is not "
                f"supported ({sorted(acts)})")
        self._act = acts[c.activation_function]

    def forward(self, x, memory=None, self_mask=None, memory_mask=None):
        x = self.self_attn_layer_norm(
            x + self.self_attn(x, key_mask=self_mask))
        if self.is_decoder:
            x = self.encoder_attn_layer_norm(
                x + self.encoder_attn(x, kv=memory, key_mask=memory_mask))
        return self.final_layer_norm(x + self.fc2(self._act(self.fc1(x))))


class _BartStack(nn.Module):
    def __init__(self, c: BartConfig, embed, is_decoder: bool, *, gen,
                 device):
        super().__init__()
        # the shared embedding, registered once on the model: kept off
        # this module's parameters so that its name is only shared.weight
        self._embed = [embed]
        self.embed_positions = Embedding(
            c.max_position_embeddings + _POS_OFFSET, c.d_model,
            std=_INIT_STD, gen=gen, device=device)
        self.layernorm_embedding = LayerNorm(c.d_model, device=device)
        n = c.decoder_layers if is_decoder else c.encoder_layers
        self.layers = nn.ModuleList([
            _BartLayer(c, is_decoder, gen=gen, device=device)
            for _ in range(n)])
        self.scale = (c.d_model ** 0.5) if c.scale_embedding else 1.0

    def forward(self, ids, memory=None, self_mask=None, memory_mask=None):
        s = ids.shape[1]
        pos = torch.arange(_POS_OFFSET, s + _POS_OFFSET, device=ids.device)
        x = self._embed[0](ids) * self.scale + self.embed_positions(pos)
        x = self.layernorm_embedding(x)
        for layer in self.layers:
            x = layer(x, memory=memory, self_mask=self_mask,
                      memory_mask=memory_mask)
        return x


class BartForConditionalGeneration(nn.Module):
    """BART with the head tied to ``shared`` plus ``final_logits_bias``
    (a ``Parameter`` with ``requires_grad=False``: carried like any
    weight, never trained; the optimizer skips it, having no gradient).

    ``device=None`` means the CUDA card and raises without one; pass
    ``device="cpu"`` for the CPU.  Weights are fp32, drawn from a
    ``torch.Generator`` seeded with ``seed`` on that device: Normal(0,
    0.02) for embeddings and projections (HF's ``init_std``), zero
    biases, unit LayerNorm scales (carry weights over with
    ``models.carry.load_paddle_tpu_state`` to compare with the JAX
    model).  BART has no dropout here, as in the JAX model."""

    def __init__(self, config: BartConfig, *, device=None, seed: int = 0):
        super().__init__()
        dev = default_device(device)
        gen = generator(seed, dev)
        self.config = config
        self.shared = Embedding(config.vocab_size, config.d_model,
                                std=_INIT_STD, gen=gen, device=dev)
        self.encoder = _BartStack(config, self.shared, is_decoder=False,
                                  gen=gen, device=dev)
        self.decoder = _BartStack(config, self.shared, is_decoder=True,
                                  gen=gen, device=dev)
        self.final_logits_bias = nn.Parameter(
            torch.zeros(config.vocab_size, device=dev, dtype=torch.float32),
            requires_grad=False)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.shared.weight.device

    def _head(self, h):
        return F.matmul(h, self.shared.weight, transpose_y=True) \
            + self.final_logits_bias

    def forward(self, input_ids, decoder_input_ids, attention_mask=None):
        """``input_ids [B, S_enc]``, ``decoder_input_ids [B, S_dec]`` and
        the encoder's 0/1 ``attention_mask [B, S_enc]`` -> ``logits [B,
        S_dec, V]``; under ``torch.no_grad`` in eval mode."""
        with torch.set_grad_enabled(self.training
                                    and torch.is_grad_enabled()):
            memory = self.encoder(input_ids, self_mask=attention_mask)
            return self._head(self.decoder(decoder_input_ids, memory=memory,
                                           memory_mask=attention_mask))

    def loss_fn(self, logits, labels):
        """The mean token cross entropy over labels other than -100."""
        v = self.config.vocab_size
        return F.cross_entropy(logits.reshape(-1, v), labels.reshape(-1),
                               ignore_index=-100, reduction="mean")

    def generate(self, input_ids, max_new_tokens: int = 20,
                 attention_mask=None, eos_token_id=None,
                 num_beams: int = 1, length_penalty: float = 1.0):
        """Greedy / beam seq2seq decode via the shared
        ``generation.seq2seq_generate`` (HF-semantics beam scorer,
        forced-eos final slot per BART's config default), in eval mode
        and under ``torch.no_grad``; the memory and the mask are repeated
        per beam in ``jnp.repeat``'s row order (each row's beams
        adjacent).  Returns the decoder ids ``[B, 1 + new]``."""
        from .generation import seq2seq_generate
        if eos_token_id is None:
            eos_token_id = self.config.eos_token_id
        b = input_ids.shape[0]
        nb = max(int(num_beams), 1)
        was_training = self.training
        self.eval()
        try:
            with torch.no_grad():
                memory = self.encoder(input_ids, self_mask=attention_mask)
                mask = attention_mask
                if nb > 1:
                    memory = memory.repeat_interleave(nb, dim=0)
                    if mask is not None:
                        mask = mask.repeat_interleave(nb, dim=0)

                def decode_step(dec_ids):
                    return self._head(self.decoder(dec_ids, memory=memory,
                                                   memory_mask=mask))

                return seq2seq_generate(
                    decode_step, self.config.decoder_start_token_id, b,
                    max_new_tokens, eos_token_id, self.config.pad_token_id,
                    num_beams=nb, length_penalty=length_penalty,
                    forced_eos_token_id=self.config.forced_eos_token_id,
                    max_positions=self.config.max_position_embeddings,
                    device=self.device)
        finally:
            if was_training:
                self.train()
