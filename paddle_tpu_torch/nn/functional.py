"""Functional ops of the training path; counterpart of the routes in
``paddle_tpu/nn/functional/{attention,norm,loss,common,activation}.py``
and ``paddle_tpu/tensor/math.py``.

Each op first applies the amp O2 rule to its inputs (``amp.cast`` with
the op's Paddle name), then takes the route the JAX package takes:

* :func:`scaled_dot_product_attention` (``[B, S, H, D]``): with no live
  dropout, the flash kernels K1 (``ops.flash_attention``); otherwise the
  plain composition of ``attention.py`` (fp32 logits and softmax,
  probabilities cast to q's dtype, dropout on them);
* :func:`layer_norm`: K2 (``ops.layer_norm``) for a last-axis norm with
  weight and bias, else the plain composition of ``norm.py``;
* :func:`cross_entropy`: K8 (``ops.softmax_ce``) for hard labels on the
  last axis with no weight, under the softmax, when the class axis is
  not vocab-sharded (``ParallelCrossEntropy`` sets ``_vocab_sharded``,
  which keeps the GPT and LLaMA criteria off K8 as in the JAX package);
  else the fp32 log-softmax and the picked logit of ``loss.py``;
* :func:`dropout`, with an explicit ``torch.Generator`` (torch and JAX
  draw different bits from one seed).

Under ``static.capture_ops`` each public op records one op under its
Paddle name (``static.capture.recorded``); what runs inside it is not
recorded.

The signatures are the reference's: its parameters, in its order, with
its defaults; a keyword-only ``generator`` follows where the op draws
random bits.  A parameter value the port does not support yet raises
``NotImplementedError``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import amp
from ..ops.flash_attention import flash_attention_bhsd
from ..ops.layer_norm import layer_norm as _layer_norm_op
from ..ops.softmax_ce import softmax_ce as _softmax_ce_op
from ..static.capture import recorded

__all__ = ["scaled_dot_product_attention", "layer_norm", "cross_entropy",
           "dropout", "linear", "embedding", "gelu", "silu", "relu",
           "softmax", "matmul"]


@recorded("dropout")
def dropout(x, p: float = 0.5, axis=None, training: bool = True,
            mode: str = "upscale_in_train", name=None, *, generator=None):
    """Upscale-in-train dropout: keep each element with probability
    ``1 - p`` and divide the kept ones by it (Paddle's default mode).
    Bits come from ``generator`` (a ``torch.Generator`` on x's device).
    ``axis`` (a mask shared along other axes) and
    ``mode="downscale_in_infer"`` raise until a slice needs them."""
    if axis is not None:
        raise NotImplementedError("dropout with axis waits for a later "
                                  "slice")
    if mode == "downscale_in_infer":
        raise NotImplementedError("dropout mode 'downscale_in_infer' waits "
                                  "for a later slice")
    if mode != "upscale_in_train":
        raise ValueError(f"unknown dropout mode {mode!r}")
    if not 0.0 <= p <= 1.0:
        raise ValueError("dropout p must be in [0, 1]")
    if p == 0.0 or not training:
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device)) / keep


@recorded("linear")
def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with the Paddle ``[in, out]`` weight;
    ``name`` is a label, ignored as in the reference."""
    x, weight, bias = amp.cast("linear", x, weight, bias)
    y = torch.matmul(x, weight)
    return y + bias if bias is not None else y


@recorded("matmul")
def matmul(x, y, transpose_x: bool = False, transpose_y: bool = False,
           name=None):
    """``paddle.matmul``: the last two axes of x and/or y transposed
    first."""
    x, y = amp.cast("matmul", x, y)
    return torch.matmul(x.transpose(-1, -2) if transpose_x else x,
                        y.transpose(-1, -2) if transpose_y else y)


@recorded("embedding")
def embedding(x, weight, padding_idx=None, sparse: bool = False, name=None):
    """Rows of ``weight`` gathered by the ids ``x``; rows whose id is
    ``padding_idx`` (negative: counted from the end) are zeros, as in the
    JAX package.  ``sparse`` is accepted for API parity and changes
    nothing, as there: the gather is dense either way."""
    (weight,) = amp.cast("embedding", weight)
    out = weight[x]
    if padding_idx is not None:
        pad = padding_idx if padding_idx >= 0 \
            else weight.shape[0] + padding_idx
        out = out.masked_fill((x == pad)[..., None], 0)
    return out


@recorded("gelu")
def gelu(x, approximate: bool = False, name=None):
    (x,) = amp.cast("gelu", x)
    return F.gelu(x, approximate="tanh" if approximate else "none")


@recorded("silu")
def silu(x, name=None):
    """``x * sigmoid(x)``; not black-listed, so under O2 it runs in the
    low dtype, as the JAX ``F.silu`` does."""
    (x,) = amp.cast("silu", x)
    return F.silu(x)


@recorded("relu")
def relu(x, name=None):
    """``max(x, 0)``; not black-listed (low dtype under O2)."""
    (x,) = amp.cast("relu", x)
    return torch.relu(x)


@recorded("softmax")
def softmax(x, axis: int = -1, dtype=None, name=None):
    """Softmax over ``axis``; black-listed under amp, so low-precision
    inputs go up to fp32 and the result stays fp32.  ``dtype`` casts the
    input first, as the reference does."""
    (x,) = amp.cast("softmax", x)
    if dtype is not None:
        x = x.to(_torch_dtype(dtype))
    return torch.softmax(x, dim=axis)


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))


def _attention_composition(q, k, v, dropout_p, is_causal, training,
                           generator):
    """``attention.py``'s plain route on ``[B, S, H, D]``."""
    hq, hkv = q.shape[2], k.shape[2]
    if hkv != hq:
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
    scale = 1.0 / math.sqrt(q.shape[-1])
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    logits = torch.matmul(qt, kt.transpose(-1, -2)).float() * scale
    if is_causal:
        s, t = logits.shape[-2], logits.shape[-1]
        causal = torch.ones(s, t, dtype=torch.bool,
                            device=q.device).tril(t - s)
        logits = logits.masked_fill(~causal, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout_p > 0.0 and training:
        probs = dropout(probs, dropout_p, training=True, generator=generator)
    return torch.matmul(probs, vt).transpose(1, 2)


@recorded("scaled_dot_product_attention")
def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True, name=None, *,
                                 generator=None):
    """Attention on ``[batch, seq, heads, head_dim]`` (GQA when key has
    fewer heads).  No live dropout: the flash kernels (K1) with
    bottom-right causal alignment; otherwise the plain composition.
    Causal with more queries than keys has no alignment and takes the
    composition too, as in the JAX package.  ``attn_mask`` raises until
    a slice needs it."""
    if attn_mask is not None:
        raise NotImplementedError("scaled_dot_product_attention with "
                                  "attn_mask waits for a later slice")
    q, k, v = amp.cast("scaled_dot_product_attention", query, key, value)
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads "
                         f"{hkv}")
    live_dropout = dropout_p > 0.0 and training
    if live_dropout or (is_causal and sq > sk):
        return _attention_composition(q, k, v, dropout_p, is_causal,
                                      training, generator)
    qt = q.transpose(1, 2).reshape(b * hq, sq, d)
    kt = k.transpose(1, 2).reshape(b * hkv, sk, d)
    vt = v.transpose(1, 2).reshape(b * hkv, sk, d)
    out = flash_attention_bhsd(qt, kt, vt, 1.0 / math.sqrt(d), is_causal,
                               q_offset=sk - sq if is_causal else 0,
                               n_rep=hq // hkv)
    return out.reshape(b, hq, sq, d).transpose(1, 2)


@recorded("layer_norm")
def layer_norm(x, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5, name=None):
    """LayerNorm over the trailing ``normalized_shape`` axes (black-listed
    under amp: low-precision inputs go up to fp32 and the output stays
    fp32).  A last-axis norm with weight and bias takes K2."""
    x, weight, bias = amp.cast("layer_norm", x, weight, bias)
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    n_norm = len(list(normalized_shape))
    if n_norm == 1 and weight is not None and bias is not None:
        return _layer_norm_op(x, weight, bias, float(epsilon))
    axes = tuple(range(x.dim() - n_norm, x.dim()))
    x32 = x.float()
    m = x32.mean(dim=axes, keepdim=True)
    var = (x32 - m).square().mean(dim=axes, keepdim=True)
    out = ((x32 - m) * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


@recorded("cross_entropy")
def cross_entropy(input, label, weight=None, ignore_index: int = -100,
                  reduction: str = "mean", soft_label: bool = False,
                  axis: int = -1, use_softmax: bool = True,
                  label_smoothing: float = 0.0, name=None,
                  _vocab_sharded: bool = False):
    """Hard-label softmax cross entropy over the last axis: 0 at
    ``ignore_index`` positions; ``"mean"`` is the masked sum over
    ``max(count, 1e-12)``, ``"sum"`` the masked sum, ``"none"`` the
    per-position loss; the result in the logits' dtype (after the amp
    cast: fp32 under O2, where the op is black-listed).  With no
    ``_vocab_sharded`` the per-position loss is K8
    (``ops.softmax_ce``), else the fp32 log-softmax and the picked
    logit.  ``weight``, ``soft_label``, ``label_smoothing``,
    ``use_softmax=False`` and other axes raise until a slice needs
    them."""
    if weight is not None:
        raise NotImplementedError("cross_entropy weight waits for a later "
                                  "slice")
    if soft_label or label_smoothing > 0.0:
        raise NotImplementedError("soft labels and label smoothing wait "
                                  "for a later slice")
    if not use_softmax:
        raise NotImplementedError("use_softmax=False waits for a later "
                                  "slice")
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"unknown reduction {reduction!r}")
    (logits,) = amp.cast("cross_entropy", input)
    if axis % logits.dim() != logits.dim() - 1:
        raise NotImplementedError("cross_entropy over another axis than "
                                  "the last waits for a later slice")
    n_classes = logits.shape[-1]
    li = label.long()
    if li.dim() == logits.dim() and li.shape[-1] == 1:
        li = li.squeeze(-1)
    valid = li != ignore_index
    zero = torch.zeros((), dtype=torch.float32, device=logits.device)
    if not _vocab_sharded:
        loss = _softmax_ce_op(logits.reshape(-1, n_classes),
                              li.reshape(-1), ignore_index).reshape(li.shape)
    else:
        safe = li.clamp(0, n_classes - 1)
        logp = torch.log_softmax(logits.float(), dim=-1)
        loss = -torch.gather(logp, -1, safe.unsqueeze(-1)).squeeze(-1)
    loss = torch.where(valid, loss, zero)
    if reduction == "mean":
        count = valid.float().sum()
        return (loss.sum() / count.clamp(min=1e-12)).to(logits.dtype)
    if reduction == "sum":
        return loss.sum().to(logits.dtype)
    return loss.to(logits.dtype)
