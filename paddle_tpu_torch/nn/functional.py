"""Functional ops of the training path; counterpart of the routes in
``paddle_tpu/nn/functional/{attention,norm,loss,common,input}.py``.

Each op first applies the amp O2 rule to its inputs (``amp.cast`` with
the op's Paddle name), then takes the route the JAX package takes:

* :func:`scaled_dot_product_attention` (``[B, S, H, D]``): with no live
  dropout, the flash kernels K1 (``ops.flash_attention``); otherwise the
  plain composition of ``attention.py`` (fp32 logits and softmax,
  probabilities cast to q's dtype, dropout on them);
* :func:`layer_norm`: K2 (``ops.layer_norm``) for a last-axis norm with
  weight and bias, else the plain composition of ``norm.py``;
* :func:`cross_entropy`: the non-kernel branch of ``loss.py`` (fp32
  log-softmax and the picked logit; ``ParallelCrossEntropy`` shuts the
  softmax-CE kernel off on the GPT path);
* :func:`dropout`, with an explicit ``torch.Generator`` (torch and JAX
  draw different bits from one seed).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import amp
from ..ops.flash_attention import flash_attention_bhsd
from ..ops.layer_norm import layer_norm as _layer_norm_op

__all__ = ["scaled_dot_product_attention", "layer_norm", "cross_entropy",
           "dropout", "linear", "embedding", "gelu", "silu", "matmul"]


def dropout(x, p: float = 0.5, training: bool = True, generator=None):
    """Upscale-in-train dropout: keep each element with probability
    ``1 - p`` and divide the kept ones by it (Paddle's default mode).
    Bits come from ``generator`` (a ``torch.Generator`` on x's device)."""
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


def linear(x, weight, bias=None):
    """``x @ weight + bias`` with the Paddle ``[in, out]`` weight."""
    x, weight, bias = amp.cast("linear", x, weight, bias)
    y = torch.matmul(x, weight)
    return y + bias if bias is not None else y


def matmul(x, y, transpose_y: bool = False):
    x, y = amp.cast("matmul", x, y)
    return torch.matmul(x, y.transpose(-1, -2) if transpose_y else y)


def embedding(ids, weight):
    (weight,) = amp.cast("embedding", weight)
    return weight[ids]


def gelu(x, approximate: bool = False):
    (x,) = amp.cast("gelu", x)
    return F.gelu(x, approximate="tanh" if approximate else "none")


def silu(x):
    """``x * sigmoid(x)``; not black-listed, so under O2 it runs in the
    low dtype, as the JAX ``F.silu`` does."""
    (x,) = amp.cast("silu", x)
    return F.silu(x)


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
        probs = dropout(probs, dropout_p, True, generator)
    return torch.matmul(probs, vt).transpose(1, 2)


def scaled_dot_product_attention(query, key, value, dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True, generator=None):
    """Attention on ``[batch, seq, heads, head_dim]`` (GQA when key has
    fewer heads).  No live dropout: the flash kernels (K1) with
    bottom-right causal alignment; otherwise the plain composition.
    Causal with more queries than keys has no alignment and takes the
    composition too, as in the JAX package.  (Masks wait for a later
    slice.)"""
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
                               sk - sq if is_causal else 0, hq // hkv)
    return out.reshape(b, hq, sq, d).transpose(1, 2)


def layer_norm(x, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5):
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


def cross_entropy(input, label, ignore_index: int = -100,
                  reduction: str = "none"):
    """Hard-label softmax cross entropy over the last axis, per position
    (``reduction="none"``, the only reduction the GPT criterion uses):
    fp32 log-softmax, the picked logit, 0 at ``ignore_index``
    positions."""
    if reduction != "none":
        raise NotImplementedError(f"reduction={reduction!r} waits for a "
                                  "later slice")
    (logits,) = amp.cast("cross_entropy", input)
    n_classes = logits.shape[-1]
    li = label.long()
    if li.dim() == logits.dim() and li.shape[-1] == 1:
        li = li.squeeze(-1)
    valid = li != ignore_index
    safe = li.clamp(0, n_classes - 1)
    logp = torch.log_softmax(logits.float(), dim=-1)
    loss = -torch.gather(logp, -1, safe.unsqueeze(-1)).squeeze(-1)
    loss = torch.where(valid, loss, torch.zeros((), dtype=loss.dtype,
                                                device=loss.device))
    return loss.to(logits.dtype)
