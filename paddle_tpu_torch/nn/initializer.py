"""Parameter initializers and ``ParamAttr``; counterpart of
``paddle_tpu/nn/initializer`` and ``paddle_tpu/framework/param_attr.py``
for the layers that take a ``weight_attr`` (the tensor-parallel layers).

An initializer called with a shape returns a new fp32 tensor on
``device``, drawn from ``generator`` (a ``torch.Generator`` on that
device; None: torch's default one).  Random draws are float32, as in the
reference; its random bits differ (carry weights over to compare).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

__all__ = ["Initializer", "Constant", "Normal", "XavierNormal", "ParamAttr"]


def _fan_in_out(shape: Sequence[int]):
    """The reference's fans: a 2-D weight is stored ``[in, out]``."""
    shape = tuple(int(s) for s in shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


class Initializer:
    def __call__(self, shape, dtype=None, block=None, *, generator=None,
                 device=None) -> torch.Tensor:
        if dtype not in (None, "float32", torch.float32):
            raise NotImplementedError("initializers draw float32 (cast "
                                      "afterwards, as amp.decorate does)")
        out = torch.empty(tuple(int(s) for s in shape), dtype=torch.float32,
                          device=device)
        with torch.no_grad():
            self._fill(out, generator)
        return out

    def _fill(self, out: torch.Tensor, generator) -> None:
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def _fill(self, out, generator):
        out.fill_(self.value)


class Normal(Initializer):
    def __init__(self, mean: float = 0.0, std: float = 1.0, name=None):
        self.mean, self.std = mean, std

    def _fill(self, out, generator):
        out.normal_(self.mean, self.std, generator=generator)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain: float = 1.0,
                 name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _fill(self, out, generator):
        fi, fo = _fan_in_out(out.shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        out.normal_(0.0, self.gain * math.sqrt(2.0 / (fi + fo)),
                    generator=generator)


class ParamAttr:
    """ref: ``framework/param_attr.py``.  The port reads ``initializer``
    and ``need_clip`` (``nn.Linear`` marks its parameters with it; the
    clips skip a parameter whose ``need_clip`` is False); other values
    than the defaults raise ``NotImplementedError``."""

    def __init__(self, name: Optional[str] = None, initializer=None,
                 learning_rate: float = 1.0, regularizer=None,
                 trainable: bool = True, do_model_average: bool = True,
                 need_clip: bool = True):
        if learning_rate != 1.0 or regularizer is not None or \
                not trainable:
            raise NotImplementedError(
                "ParamAttr learning_rate, regularizer and trainable wait "
                "for a later slice")
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip
