"""The decode-block pieces the GPT ragged serving step calls; plain
torch copies of ``paddle_tpu/ops/pallas/fused_decode.py``'s reference
compositions.

``norm_mlp`` has no kernel here, on purpose.  The JAX package routes it
to its Pallas kernel ``_norm_mlp_kernel`` only while ``w1`` and ``w2``
fit its 10 MiB VMEM budget (``_VMEM_BUDGET_BYTES``, gated in
``norm_mlp``); at served widths they do not (gpt3-1.3B: 2048 x 8192 x
4 B x 2 = 128 MiB), so even on a TPU it runs the composition below —
LayerNorm, two plain matmuls and a tanh gelu — and the matmuls belong
to the BLAS library, as the JAX package left them to XLA.  The fused
kernel (and its rope/qkv and attend siblings of the ``decode_loop``
path) is queued in ROADMAP.md for the decode-loop slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["reference_layer_norm", "norm_mlp"]


def reference_layer_norm(v, w, b, eps: float):
    """Mirror of the JAX package's ``reference_layer_norm``: fp32
    statistics, the normalized value cast back to the input dtype
    before ``* w + b``."""
    v32 = v.float()
    m = v32.mean(dim=-1, keepdim=True)
    var = (v32 - m).square().mean(dim=-1, keepdim=True)
    out = ((v32 - m) * torch.rsqrt(var + eps)).to(v.dtype)
    return out * w + b


def norm_mlp(x, *, kind, norm_w, norm_b=None, w1, b1=None, w2, b2=None,
             eps=1e-5, act="gelu_tanh"):
    """Norm + MLP tail of one decoder block on ``x [N, H]``:
    LayerNorm -> ``w1``/``b1`` -> gelu -> ``w2``/``b2`` (``[in, out]``
    weights).  Only ``kind='layer_norm'`` (GPT) is ported so far; the
    residual add stays with the caller."""
    if kind != "layer_norm":
        raise NotImplementedError(
            f"norm_mlp kind={kind!r}: only 'layer_norm' (GPT) is ported")
    h = reference_layer_norm(x, norm_w, norm_b, eps)
    a = torch.matmul(h, w1)
    if b1 is not None:
        a = a + b1
    a = F.gelu(a, approximate="tanh" if act == "gelu_tanh" else "none")
    y = torch.matmul(a, w2)
    return y + b2 if b2 is not None else y
