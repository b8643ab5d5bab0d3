"""The port's gradient clips (``paddle_tpu_torch.nn.clip``) against the
JAX package's (``paddle_tpu.nn.clip``) on the CPU, in one process.

The same numpy gradients go through both: ``ClipGradByValue``,
``ClipGradByNorm`` and ``ClipGradByGlobalNorm`` on ``[(param, grad)]``
lists, ``nn.utils.clip_grad_norm_`` (2-norm, 1-norm and ``inf``) and
``clip_grad_value_`` on parameters' gradients, with a parameter built
with ``ParamAttr(need_clip=False)`` in both packages (a ``Linear``'s
weight), which every clip class leaves alone and the global norm does
not count; then three AdamW steps on a tiny ``Linear`` stack with each
clip class in the optimizer.

Tolerances: fp32 ``rtol = atol = 1e-6`` (the same fp32 sums in another
order); bf16 gradients ``2e-2`` (one bf16 rounding of the product);
the AdamW runs' parameters ``atol = 1e-6``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.nn import clip as jclip

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.nn import clip as tclip
from paddle_tpu_torch.nn.initializer import ParamAttr

FP32_TOL = 1e-6
BF16_TOL = 2e-2
SHAPES = [(4, 3), (3,), (5, 2), (2, 2)]


def _grads(seed, scale=1.0):
    rs = np.random.RandomState(seed)
    return [(rs.randn(*s) * scale).astype(np.float32) for s in SHAPES]


def _pairs(grads, dtype):
    """Both packages' ``(param, grad)`` lists: the first parameter is a
    ``Linear`` weight built with ``need_clip=False``."""
    paddle.seed(0)
    jlin = jnn.Linear(4, 3, weight_attr=paddle.ParamAttr(need_clip=False))
    tlin = tnn.Linear(4, 3, weight_attr=ParamAttr(need_clip=False),
                      device="cpu")
    jparams = [jlin.weight] + [paddle.create_parameter(list(g.shape),
                                                       "float32")
                               for g in grads[1:]]
    tparams = [tlin.weight] + [torch.nn.Parameter(torch.zeros(g.shape))
                               for g in grads[1:]]
    jdt = "bfloat16" if dtype == torch.bfloat16 else "float32"
    jpg = [(p, Tensor(paddle.to_tensor(g).astype(jdt)._data))
           for p, g in zip(jparams, grads)]
    tpg = [(p, torch.tensor(g).to(dtype)) for p, g in zip(tparams, grads)]
    return jpg, tpg


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t._data.astype("float32"))


def _close(jout, tout, dtype):
    tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
    for (_, jg), (_, tg) in zip(jout, tout):
        np.testing.assert_allclose(_np(tg), _np(jg), rtol=tol, atol=tol)


CLIPS = {
    "value": (lambda: jclip.ClipGradByValue(0.5),
              lambda: tclip.ClipGradByValue(0.5)),
    "value_min": (lambda: jclip.ClipGradByValue(0.4, min=-0.1),
                  lambda: tclip.ClipGradByValue(0.4, min=-0.1)),
    "norm": (lambda: jclip.ClipGradByNorm(1.0),
             lambda: tclip.ClipGradByNorm(1.0)),
    "global_norm": (lambda: jclip.ClipGradByGlobalNorm(1.0),
                    lambda: tclip.ClipGradByGlobalNorm(1.0)),
    "global_norm_above": (lambda: jclip.ClipGradByGlobalNorm(100.0),
                          lambda: tclip.ClipGradByGlobalNorm(100.0)),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("kind", list(CLIPS))
def test_clip_classes_match_jax(kind, dtype):
    jpg, tpg = _pairs(_grads(1, scale=2.0), dtype)
    jmake, tmake = CLIPS[kind]
    jout, tout = jmake()(jpg), tmake()(tpg)
    _close(jout, tout, dtype)
    # the need_clip=False weight passes untouched
    assert torch.equal(tout[0][1], tpg[0][1])


def test_global_norm_leaves_out_need_clip_false():
    """The norm counts the clipped parameters only: the port's kept norm
    equals the numpy norm of the others."""
    grads = _grads(2, scale=2.0)
    _, tpg = _pairs(grads, torch.float32)
    clip = tclip.ClipGradByGlobalNorm(1.0)
    clip(tpg)
    want = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                       for g in grads[1:]))
    np.testing.assert_allclose(float(clip.last_norm), want, rtol=FP32_TOL)
    assert float(clip.last_local_norm) == float(clip.last_norm)


def _param_grads(grads):
    """Both packages' parameters with ``grads`` as their gradients."""
    jps, tps = [], []
    for g in grads:
        jp = paddle.create_parameter(list(g.shape), "float32")
        jp._grad = Tensor(paddle.to_tensor(g)._data)
        jps.append(jp)
        tp = torch.nn.Parameter(torch.zeros(g.shape))
        tp.grad = torch.tensor(g)
        tps.append(tp)
    return jps, tps


@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")],
                         ids=["l2", "l1", "inf"])
def test_clip_grad_norm_matches_jax(norm_type):
    grads = _grads(3, scale=3.0)
    jps, tps = _param_grads(grads)
    jtotal = jnn.utils.clip_grad_norm_(jps, 1.5, norm_type=norm_type)
    ttotal = tnn.utils.clip_grad_norm_(tps, 1.5, norm_type=norm_type)
    np.testing.assert_allclose(float(ttotal), float(jtotal), rtol=FP32_TOL)
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.grad.numpy(), _np(jp._grad),
                                   rtol=FP32_TOL, atol=FP32_TOL)


def test_clip_grad_value_matches_jax():
    grads = _grads(4, scale=2.0)
    jps, tps = _param_grads(grads)
    jnn.utils.clip_grad_value_(jps, 0.7)
    tnn.utils.clip_grad_value_(tps, 0.7)
    for jp, tp in zip(jps, tps):
        np.testing.assert_array_equal(tp.grad.numpy(), _np(jp._grad))


def test_clip_functions_take_the_reference_signatures():
    import inspect
    for name in ("clip_grad_norm_", "clip_grad_value_"):
        ref = inspect.signature(getattr(jclip, name))
        port = inspect.signature(getattr(tclip, name))
        assert list(ref.parameters.items()) == \
            list(port.parameters.items()), name
    for name in ("ClipGradByValue", "ClipGradByNorm"):
        ref = inspect.signature(getattr(jclip, name).__init__)
        port = inspect.signature(getattr(tclip, name).__init__)
        assert list(ref.parameters.items()) == \
            list(port.parameters.items()), name


def _stack_run(jclip_obj, tclip_obj, steps=3):
    """Three AdamW steps of a 2-layer ``Linear`` stack (the first
    layer's weight ``need_clip=False``) on the same batch in both
    packages; both stacks' parameters after."""
    paddle.seed(7)
    attr = paddle.ParamAttr(need_clip=False)
    jl = [jnn.Linear(6, 5, weight_attr=attr), jnn.Linear(5, 3)]
    tl = [tnn.Linear(6, 5, weight_attr=ParamAttr(need_clip=False),
                     device="cpu"), tnn.Linear(5, 3, device="cpu")]
    with torch.no_grad():
        for j, t in zip(jl, tl):
            t.weight.copy_(torch.tensor(np.asarray(j.weight._data)))
            t.bias.copy_(torch.tensor(np.asarray(j.bias._data)))
    jp = [p for m in jl for p in m.parameters()]
    tp = [p for m in tl for p in m.parameters()]
    jo = jopt.AdamW(learning_rate=0.05, parameters=jp, grad_clip=jclip_obj)
    to = topt.AdamW(learning_rate=0.05, parameters=tp, grad_clip=tclip_obj)
    rs = np.random.RandomState(8)
    x = rs.randn(4, 6).astype(np.float32) * 3
    for _ in range(steps):
        h = jl[1](paddle.nn.functional.relu(jl[0](paddle.to_tensor(x))))
        (h * h).sum().backward()
        jo.step()
        jo.clear_grad()
        th = tl[1](torch.relu(tl[0](torch.tensor(x))))
        (th * th).sum().backward()
        to.step()
        to.clear_grad()
    return [np.asarray(p._data) for p in jp], \
        [p.detach().numpy() for p in tp]


@pytest.mark.parametrize("kind", ["value", "norm", "global_norm"])
def test_optimizer_takes_each_clip(kind):
    jmake, tmake = CLIPS[kind]
    jw, tw = _stack_run(jmake(), tmake())
    for a, b in zip(jw, tw):
        np.testing.assert_allclose(b, a, rtol=0, atol=FP32_TOL)


def test_a_grad_clip_that_is_not_a_clip_raises():
    with pytest.raises(NotImplementedError, match="grad_clip"):
        topt.AdamW(parameters=[torch.nn.Parameter(torch.zeros(2))],
                   grad_clip=lambda pg: pg)
