"""The layers an MoE expert is made of; counterpart of
``paddle_tpu/nn/layer/common.py`` ``Linear`` and ``activation.py``
``GELU``.

``Linear`` keeps the Paddle ``[in, out]`` weight (XavierNormal by
default, as in the JAX package; the bias zeros, none for ``bias_attr=
False``) and runs ``nn.functional.linear``, so it follows the amp O2
rule.  Weights are drawn from ``generator`` on ``device`` (the device
rule: ``None`` is the card); on the ``meta`` device nothing is drawn
(a placeholder whose values another rank holds).
"""
from __future__ import annotations

import torch
from torch import nn

from ..device import default_device
from . import functional as F
from .initializer import Constant, XavierNormal

__all__ = ["Linear", "GELU"]


class Linear(nn.Module):
    """The reference's parameters in its order; ``weight_attr`` /
    ``bias_attr`` read their ``initializer`` and ``need_clip``
    (``bias_attr=False``: no bias); ``name`` is a label."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, bias_attr=None, name=None, *,
                 generator=None, device=None):
        super().__init__()
        dev = default_device(device) if device != "meta" \
            else torch.device("meta")
        gen = generator if dev.type != "meta" else None
        w_init = getattr(weight_attr, "initializer", None) or XavierNormal()
        self.weight = nn.Parameter(w_init(
            [in_features, out_features], generator=gen, device=dev))
        if bias_attr is False:
            self.bias = None
        else:
            b_init = getattr(bias_attr, "initializer", None) or Constant(0.0)
            self.bias = nn.Parameter(b_init([out_features], generator=gen,
                                            device=dev))
        for p, attr in ((self.weight, weight_attr), (self.bias, bias_attr)):
            if p is not None and getattr(attr, "need_clip", True) is False:
                p.need_clip = False

    def forward(self, x):
        if getattr(self.weight, "_dist_attr", None) is not None or \
                getattr(self.bias, "_dist_attr", None) is not None:
            from ..distributed.auto_parallel.api import placed_linear
            return placed_linear(self, x)
        return F.linear(x, self.weight, self.bias)


class GELU(nn.Module):
    """``nn.functional.gelu`` (exact unless ``approximate``)."""

    def __init__(self, approximate: bool = False, name=None):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(x, approximate=self.approximate)
