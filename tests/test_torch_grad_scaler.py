"""The port's ``amp.GradScaler`` against the JAX package's on the CPU.

* The tiny GPT under amp O2 bf16 (JAX weights carried into the port),
  AdamW(1e-3, wd 0.01, fp32 masters) with ``ClipGradByGlobalNorm(1.0)``,
  ``GradScaler(2 ** 10, incr_every_n_steps=2)``, through both packages'
  ``jit.train_step(..., scaler=)``, 10 steps on one batch.  Before step
  ``POISON_STEP`` one element of a weight is set to ``inf`` in both
  packages (the loss and every gradient turn non-finite), and healed
  after it.  Held: the scale, growth and decrease counters after every
  step equal (exactly) to the JAX scaler's, the poisoned step skipped in
  both (every parameter, fp32 master, moment and beta power bit-equal to
  the step before, the scale halved), the losses within ``3.2e-2`` (one
  bf16 ulp in [4, 8)) and the masters as ``test_torch_gpt_training.py``
  holds them after O2 steps (the median difference of each tensor
  within ``5e-5``, every element within ``2 x steps x lr``).
* A ``Linear`` in fp32 under SGD through ``scaler.minimize``, three of
  six losses ``inf``, under four settings (``decr_every_n_nan_or_inf=
  2``, other ratios, static scaling, disabled): the same scale and
  counters after every step as the JAX scaler's, weights within
  ``1e-6`` of its weights and bit-equal across each skip.
* ``state_dict`` / ``set_state_dict``, ``minimize``, ``enable=False``
  and ``use_dynamic_loss_scaling=False`` as in the JAX package.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu import amp as jamp
from paddle_tpu.jit import train_step as jax_train_step
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.models.gpt import gpt_config as jax_gpt_config

from paddle_tpu_torch import amp, nn, optimizer
from paddle_tpu_torch.jit import train_step
from paddle_tpu_torch.models import (GPTForPretraining, gpt_config,
                                     load_paddle_tpu_state)

_NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
LR, WD = 1e-3, 0.01
STEPS = 10
POISON_STEP = 6
POISONED = "gpt.layers.0.mlp.fc1.weight"
LOSS_ATOL = 3.2e-2
MASTER_MEDIAN = 5e-5
MASTER_MAX = 2 * STEPS * LR


def _o2(pkg):
    def fn(m, ids, labels):
        with pkg.auto_cast(enable=True, level="O2", dtype="bfloat16"):
            return m.loss_fn(m(ids), labels)
    return fn


def _jax_state(jm, jo, js):
    params = {n: np.asarray(p._data.astype("float32"))
              for n, p in jm.named_parameters()}
    acc = {(a, k): np.asarray(v) for a, store in jo._accumulators.items()
           for k, v in store.items()}
    master = {k: np.asarray(v) for k, v in jo._master_weights.items()}
    return params, acc, master


def _port_state(pm, po):
    params = {n: p.detach().float().numpy().copy()
              for n, p in pm.named_parameters()}
    state = {(n, k): v.numpy().copy()
             for n, p in pm.named_parameters()
             for k, v in po.state[p].items()}
    return params, state


def _poison(pkg_param, port: bool):
    if port:
        with torch.no_grad():
            clean = pkg_param.detach().clone()
            pkg_param.view(-1)[0] = float("inf")
        return lambda: pkg_param.data.copy_(clean)
    clean = pkg_param._data
    pkg_param._data = clean.at[(0,) * clean.ndim].set(np.inf)

    def heal():
        pkg_param._data = clean
    return heal


@pytest.fixture(scope="module")
def run():
    paddle.seed(0)
    jm = JaxGPT(jax_gpt_config("tiny", **_NO_DROPOUT))
    arrays = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    pm = GPTForPretraining(gpt_config("tiny", **_NO_DROPOUT), device="cpu")
    load_paddle_tpu_state(pm, arrays)
    jo = jopt.AdamW(learning_rate=LR, parameters=jm.parameters(),
                    weight_decay=WD, multi_precision=True,
                    grad_clip=jnn.ClipGradByGlobalNorm(1.0))
    po = optimizer.AdamW(learning_rate=LR, parameters=pm.parameters(),
                         weight_decay=WD, multi_precision=True,
                         grad_clip=nn.ClipGradByGlobalNorm(1.0))
    jm, jo = jamp.decorate(models=jm, optimizers=jo, level="O2",
                           dtype="bfloat16")
    pm, po = amp.decorate(models=pm, optimizers=po, level="O2",
                          dtype="bfloat16")
    js = jamp.GradScaler(init_loss_scaling=2.0 ** 10, incr_every_n_steps=2)
    ps = amp.GradScaler(init_loss_scaling=2.0 ** 10, incr_every_n_steps=2)
    jstep = jax_train_step(jm, None, jo, scaler=js, step_fn=_o2(jamp))
    pstep = train_step(pm, None, po, scaler=ps, step_fn=_o2(amp))
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 512, (2, 16)).astype(np.int64)
    labels = rs.randint(0, 512, (2, 16)).astype(np.int64)
    out = dict(jl=[], pl=[], jseq=[], pseq=[])
    jparams = dict(jm.named_parameters())
    pparams = dict(pm.named_parameters())
    for i in range(STEPS):
        if i == POISON_STEP:
            out["j_before"] = _jax_state(jm, jo, js)
            out["p_before"] = _port_state(pm, po)
            heals = [_poison(jparams[POISONED], False),
                     _poison(pparams[POISONED], True)]
        out["jl"].append(float(jstep(ids, labels)))
        out["pl"].append(float(pstep(ids, labels)))
        if i == POISON_STEP:
            for heal in heals:
                heal()
            out["j_after"] = _jax_state(jm, jo, js)
            out["p_after"] = _port_state(pm, po)
        out["jseq"].append((float(js._scale), int(js._incr_count),
                            int(js._decr_count)))
        out["pseq"].append((float(ps._scale), ps._incr_count,
                            ps._decr_count))
    out.update(jm=jm, jo=jo, js=js, pm=pm, po=po, ps=ps)
    return out


def test_scale_and_counters_match_jax_exactly(run):
    assert run["pseq"] == run["jseq"]
    scales = [s for s, _, _ in run["pseq"]]
    assert max(scales) > 2.0 ** 10                     # it grew
    assert scales[POISON_STEP] == scales[POISON_STEP - 1] / 2


def test_losses_match_jax(run):
    jl, pl = run["jl"], run["pl"]
    assert not np.isfinite(jl[POISON_STEP])
    assert not np.isfinite(pl[POISON_STEP])
    keep = [i for i in range(STEPS) if i != POISON_STEP]
    np.testing.assert_allclose([pl[i] for i in keep], [jl[i] for i in keep],
                               rtol=0, atol=LOSS_ATOL)
    assert pl[-1] < pl[0]


def test_the_poisoned_step_moves_nothing(run):
    """Both packages skip it: parameters (the poisoned one healed),
    masters, moments and beta powers bit-equal to the step before."""
    for before, after in ((run["p_before"], run["p_after"]),
                          (run["j_before"], run["j_after"])):
        for b, a in zip(before, after):
            assert b.keys() == a.keys()
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))


def test_masters_and_moments_match_jax(run):
    jm, jo, pm, po = run["jm"], run["jo"], run["pm"], run["po"]
    keys = {n: p.name or f"param_{i}"
            for i, (n, p) in enumerate(jm.named_parameters())}
    checked = 0
    for name, p in pm.named_parameters():
        st = po.state[p]
        assert ("master" in st) == (keys[name] in jo._master_weights), name
        if "master" in st:
            want = np.asarray(jo._master_weights[keys[name]])
            d = np.abs(st["master"].numpy() - want)
            assert np.median(d) < MASTER_MEDIAN and d.max() < MASTER_MAX, \
                name
            checked += 1
        pows = np.asarray([jo._accumulators["beta1_pow"][keys[name]],
                           jo._accumulators["beta2_pow"][keys[name]]])
        np.testing.assert_allclose(st["beta_pows"].numpy(), pows, rtol=1e-6)
    assert checked > 0


def test_state_dict_round_trip(run):
    ps, js = run["ps"], run["js"]
    sd = ps.state_dict()
    assert sd == js.state_dict()
    fresh = amp.GradScaler()
    fresh.set_state_dict(sd)
    assert fresh.state_dict() == {**sd, **{
        k: fresh.state_dict()[k] for k in
        ("incr_ratio", "decr_ratio", "incr_every_n_steps",
         "decr_every_n_nan_or_inf", "use_dynamic_loss_scaling")}}
    assert (float(fresh._scale), fresh._incr_count, fresh._decr_count) == \
        (sd["scale"], sd["incr_count"], sd["decr_count"])


def _linear_run(pkg, opt_mod, scaler_kw, bad_steps, steps=6):
    """A ``Linear(4, 3)`` in fp32 under SGD through ``scaler.minimize``;
    the loss is ``inf`` on ``bad_steps``.  The scale sequence, the
    counters and the weights after each step."""
    rs = np.random.RandomState(3)
    w0 = rs.randn(4, 3).astype(np.float32)
    x = rs.randn(5, 4).astype(np.float32)
    scaler = pkg.GradScaler(**scaler_kw)
    seq, weights = [], []
    if pkg is amp:
        w = torch.nn.Parameter(torch.tensor(w0))
        opt = opt_mod.SGD(learning_rate=0.1, parameters=[w])
        for i in range(steps):
            bad = float("inf") if i in bad_steps else 1.0
            loss = ((torch.tensor(x) @ w) ** 2).mean() * bad
            scaled = scaler.scale(loss)
            scaled.backward()
            scaler.minimize(opt, scaled)
            opt.clear_grad()
            seq.append((float(scaler._scale), scaler._incr_count,
                        scaler._decr_count))
            weights.append(w.detach().numpy().copy())
    else:
        w = paddle.create_parameter([4, 3], "float32")
        w.set_value(paddle.to_tensor(w0))
        opt = opt_mod.SGD(learning_rate=0.1, parameters=[w])
        for i in range(steps):
            bad = float("inf") if i in bad_steps else 1.0
            loss = (paddle.matmul(paddle.to_tensor(x), w) ** 2).mean() * bad
            scaled = scaler.scale(loss)
            scaled.backward()
            scaler.minimize(opt, scaled)
            opt.clear_grad()
            seq.append((float(scaler._scale), int(scaler._incr_count),
                        int(scaler._decr_count)))
            weights.append(np.asarray(w._data).copy())
    return seq, weights


@pytest.mark.parametrize("kw", [
    dict(init_loss_scaling=8.0, incr_every_n_steps=2,
         decr_every_n_nan_or_inf=2),
    dict(init_loss_scaling=4.0, decr_ratio=0.25, incr_ratio=4.0,
         incr_every_n_steps=3),
    dict(init_loss_scaling=8.0, use_dynamic_loss_scaling=False),
    dict(init_loss_scaling=8.0, enable=False),
], ids=["decr_every_2", "ratios", "static", "disabled"])
def test_counters_and_skips_match_jax(kw):
    bad = {1, 2, 4}
    pseq, pw = _linear_run(amp, optimizer, kw, bad)
    jseq, jw = _linear_run(jamp, jopt, kw, bad)
    assert pseq == jseq
    enabled = kw.get("enable", True)
    for i, (a, b) in enumerate(zip(pw, jw)):
        if not enabled:
            continue                   # nothing skips: the weights go inf
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
        if i in bad:                   # a skipped step moves nothing
            np.testing.assert_array_equal(a, pw[i - 1])


def test_scaler_accessors_match_jax():
    for kw in ({}, dict(enable=False, use_dynamic_loss_scaling=False,
                        init_loss_scaling=2.0)):
        p, j = amp.GradScaler(**kw), jamp.GradScaler(**kw)
        assert p.is_enable() == j.is_enable()
        assert p.is_use_dynamic_loss_scaling() == \
            j.is_use_dynamic_loss_scaling()
        assert p.get_init_loss_scaling() == j.get_init_loss_scaling()
        p.set_init_loss_scaling(512.0)
        j.set_init_loss_scaling(512.0)
        assert p.get_init_loss_scaling() == j.get_init_loss_scaling()
        assert p.state_dict() == j.state_dict()


def test_scale_moves_to_the_loss_device_and_counts_host_reads():
    s = amp.GradScaler(init_loss_scaling=4.0)
    w = torch.nn.Parameter(torch.ones(3))
    opt = optimizer.SGD(learning_rate=0.1, parameters=[w])
    loss = s.scale((w * 2).sum())
    assert s._scale.device == loss.device and s._scale.dim() == 0
    loss.backward()
    s.step(opt)
    s.update()
    assert s.host_reads == 1
    np.testing.assert_allclose(w.detach().numpy(), 0.8, rtol=1e-6)


def test_float16_still_raises():
    m = GPTForPretraining(gpt_config("tiny"), device="cpu")
    with pytest.raises(NotImplementedError, match="bfloat16"):
        amp.decorate(m, level="O2", dtype="float16")
