"""The port's ERNIE-MoE held against the JAX package on the CPU: the
tiny preset's weights made by ``paddle_tpu`` (seed 0) are carried into
``paddle_tpu_torch`` by name, and both packages run the same numpy
batch (MLM labels, ~30 % kept, as ``tests/test_ernie_moe.py`` draws
them; dropout 0).

Tolerances (``PERF.md``, "Parity tolerances"):
* eval logits atol 1e-5, the loss and each gate's aux loss rtol 1e-5
  (fp32, the same formulas);
* fp32, 3 AdamW steps (lr 1e-3, weight decay 0.01) through both
  ``jit.train_step``: losses atol 1e-5, parameters atol 1e-4 (the
  training tests' bounds), at the preset's ``capacity_factor`` and at
  0.5 (tokens dropped) with ``ClipGradForMOEByGlobalNorm`` below the
  gradients' norm;
* amp O2 bf16, 3 steps: losses atol 3.2e-2 (one bf16 ulp of values in
  [4, 8)), fp32 masters within 6 x lr of the JAX masters, the dense
  ones' median difference within 5e-5 (as the GPT test holds them).  An
  expert's median is not held: a bf16 gate logit one ulp apart in the
  two packages can send a token to another expert in block 1, which then
  moves that expert's whole gradient (measured: 5.8e-5 to 1.3e-4 on two
  of block 1's 8 experts, under 3e-6 on block 0's).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu import amp as jamp
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.incubate.distributed.models.moe import (
    ClipGradForMOEByGlobalNorm as JaxMoEClip)
from paddle_tpu.jit import train_step as jax_train_step
from paddle_tpu.models import ErnieMoEForPretraining as JaxErnie
from paddle_tpu.models import ernie_moe_config as jax_ernie_config

from paddle_tpu_torch import amp, optimizer
from paddle_tpu_torch.incubate.distributed.models.moe import (
    ClipGradForMOEByGlobalNorm)
from paddle_tpu_torch.jit import train_step
from paddle_tpu_torch.models import (ErnieMoEForPretraining,
                                     ernie_moe_config, load_paddle_tpu_state)
from paddle_tpu_torch.models.ernie_moe import expert_seed

NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
LR, WD = 1e-3, 0.01
STEPS = 3


def _data(b=4, s=16, seed=0, vocab=256):
    """``tests/test_ernie_moe.py``'s ``_data``."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, vocab, (b, s)).astype(np.int64)
    labels = ids.copy()
    labels[rs.rand(b, s) > 0.3] = -100
    return ids, labels


def _pair(**over):
    paddle.seed(0)
    jm = JaxErnie(jax_ernie_config("tiny", **NO_DROPOUT, **over))
    arrays = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    pm = ErnieMoEForPretraining(ernie_moe_config("tiny", **NO_DROPOUT,
                                                 **over), device="cpu")
    load_paddle_tpu_state(pm, arrays)
    return jm, pm


def test_logits_loss_and_gate_losses_match_jax():
    jm, pm = _pair()
    jm.eval()
    ids, labels = _data(b=2)
    jl = jm(Tensor(ids))
    pl = pm(torch.tensor(ids))
    assert list(pl.shape) == [2, 16, 256]
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl._data), rtol=0,
                               atol=1e-5)
    jloss = jm.loss_fn(jl, Tensor(labels))
    ploss = pm.loss_fn(pl, torch.tensor(labels))
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5)
    jg = [float(g) for g in jm.ernie.gate_losses()]
    pg = [float(g) for g in pm.ernie.gate_losses()]
    assert len(pg) == pm.config.num_layers == 2
    np.testing.assert_allclose(pg, jg, rtol=1e-5)


def _run(o2: bool, clip=None, **over):
    jm, pm = _pair(**over)
    jo = jopt.AdamW(learning_rate=LR, parameters=jm.parameters(),
                    weight_decay=WD, multi_precision=True,
                    grad_clip=JaxMoEClip(clip) if clip else None)
    po = optimizer.AdamW(learning_rate=LR, parameters=pm.parameters(),
                         weight_decay=WD, multi_precision=True,
                         grad_clip=ClipGradForMOEByGlobalNorm(clip)
                         if clip else None)
    if o2:
        jm, jo = jamp.decorate(models=jm, optimizers=jo, level="O2",
                               dtype="bfloat16")
        pm, po = amp.decorate(models=pm, optimizers=po, level="O2",
                              dtype="bfloat16")

        def jfn(m, ids, labels):
            with jamp.auto_cast(enable=True, level="O2", dtype="bfloat16"):
                return m.loss_fn(m(ids), labels)

        def pfn(m, ids, labels):
            with amp.auto_cast(enable=True, level="O2", dtype="bfloat16"):
                return m.loss_fn(m(ids), labels)
    else:
        def jfn(m, ids, labels):
            return m.loss_fn(m(ids), labels)
        pfn = jfn
    jstep = jax_train_step(jm, None, jo, step_fn=jfn)
    pstep = train_step(pm, None, po, step_fn=pfn)
    ids, labels = _data()
    jl = [float(jstep(ids, labels)) for _ in range(STEPS)]
    pl = [float(pstep(ids, labels)) for _ in range(STEPS)]
    return jm, jo, jl, pm, po, pl


FP32_CASES = {"preset": {}, "drops-clip": dict(capacity_factor=0.5,
                                               clip=0.05)}


@pytest.mark.parametrize("case", list(FP32_CASES))
def test_fp32_curve_matches_jax(case):
    over = dict(FP32_CASES[case])
    clip = over.pop("clip", None)
    jm, _, jl, pm, _, pl = _run(False, clip, **over)
    np.testing.assert_allclose(pl, jl, rtol=0, atol=1e-5)
    assert pl[-1] < pl[0]
    want = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0,
                                   atol=1e-4, err_msg=name)


def test_o2_curve_matches_jax():
    jm, jo, jl, pm, po, pl = _run(True)
    np.testing.assert_allclose(pl, jl, rtol=0, atol=3.2e-2)
    assert pl[-1] < pl[0]
    keys = {n: p.name or f"param_{i}"
            for i, (n, p) in enumerate(jm.named_parameters())}
    jmaster = {n: np.asarray(jo._master_weights[k]) for n, k in keys.items()
               if k in jo._master_weights}
    checked = 0
    for name, p in pm.named_parameters():
        master = po.state[p].get("master")
        assert (master is None) == (name not in jmaster), name
        assert (p.dtype == torch.float32) == (".ln" in name
                                              or "layer_norm" in name), name
        if master is not None:
            diff = np.abs(master.numpy() - jmaster[name])
            assert diff.max() <= 6 * LR, name
            if ".experts." not in name:
                assert np.median(diff) <= 5e-5, name
            checked += 1
    assert checked == len(jmaster) > 0


def test_state_dict_names_and_expert_seeds():
    """The JAX package's parameter names; each expert drawn from its own
    generator (``expert_seed``), so it is the same tensor at any expert
    degree; the gate's and the dense weights from the model's."""
    paddle.seed(0)
    jm = JaxErnie(jax_ernie_config("tiny"))
    pm = ErnieMoEForPretraining(ernie_moe_config("tiny"), device="cpu",
                                seed=3)
    assert [n for n, _ in pm.named_parameters()] == \
        [n for n, _ in jm.named_parameters()]
    w = pm.ernie.blocks[1].ffn.experts[5][0].weight
    g = torch.Generator().manual_seed(expert_seed(3, 1, 5))
    want = torch.empty_like(w).normal_(0.0, 0.02, generator=g)
    torch.testing.assert_close(w.detach(), want, rtol=0, atol=0)
    assert w.expert_index == 5
