"""The PyTorch port's LLaMA training slice held against the JAX package on
the CPU: tiny-LLaMA weights made by ``paddle_tpu`` (the ``tiny`` preset:
GQA with 4 query and 2 kv heads, so the attention's ``n_rep`` route runs
too) are carried into ``paddle_tpu_torch``, and both packages'
``train_step`` run the same numpy batch with AdamW (lr 1e-3, weight decay
0.01; LLaMA has no dropout).

Tolerances:
* fp32, 10 steps: losses atol 1e-5 and parameters atol 1e-4 (the same
  math in another summation order; Adam's normalised update turns a
  last-bit difference of a small gradient into up to ~1e-5 of a weight
  per step, so the weights drift apart by more than the losses);
* amp O2 bf16, 3 steps: losses atol 3.2e-2, one bf16 step of values in
  [4, 8) (the O2 loss is a bf16 value on both sides).  fp32 master
  weights: the median difference of each tensor within 5e-5, every
  element within 6e-3 = 2 x 3 steps x lr.  bf16 activations round at
  other places in XLA and torch, and the rotary embedding differs on
  purpose: the JAX step is jitted, and its rope gate gives up on a traced
  table (``incubate/nn/functional/__init__.py:63``), so it rotates q/k
  with the jnp composition in bf16 (``x·cos`` and ``rot·sin`` each
  rounded, then their sum), while the port's eager step takes the rope
  kernel route, which computes in fp32 from the bf16-rounded tables and
  rounds once.  Where a gradient is only rounding noise, its sign may
  differ between the two, and Adam's normalised step moves such a weight
  by up to lr either way;
* the criterion: atol 1e-6 (fp32, same formula).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu import amp as jamp
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.jit import train_step as jax_train_step
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import LlamaPretrainingCriterion as JaxCriterion
from paddle_tpu.models.llama import llama_config as jax_llama_config

from paddle_tpu_torch import amp, optimizer
from paddle_tpu_torch.jit import train_step
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_config,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.models.llama import LlamaPretrainingCriterion

LR, WD = 1e-3, 0.01


def _batch(seed=0, b=2, s=16, vocab=256):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, vocab, (b, s)).astype(np.int64)
    labels = rs.randint(0, vocab, (b, s)).astype(np.int64)
    labels[0, :3] = -100                 # ignored positions in the loss
    return ids, labels


def _carried(**overrides):
    """A JAX tiny LLaMA and the port's with its weights."""
    paddle.seed(0)
    jm = JaxLlama(jax_llama_config("tiny", **overrides))
    arrays = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    pm = LlamaForCausalLM(llama_config("tiny", **overrides), device="cpu")
    load_paddle_tpu_state(pm, arrays)
    return jm, pm


def _run(o2: bool, steps: int):
    jm, pm = _carried()
    jo = jopt.AdamW(learning_rate=LR, parameters=jm.parameters(),
                    weight_decay=WD, multi_precision=True)
    po = optimizer.AdamW(learning_rate=LR, parameters=pm.parameters(),
                         weight_decay=WD, multi_precision=True)
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
    ids, labels = _batch()
    jl = [float(jstep(ids, labels)) for _ in range(steps)]
    pl = [float(pstep(ids, labels)) for _ in range(steps)]
    return jm, jo, jl, pm, po, pl


@pytest.fixture(scope="module")
def fp32_run():
    return _run(False, 10)


@pytest.fixture(scope="module")
def o2_run():
    return _run(True, 3)


def test_fp32_loss_curve_matches_jax(fp32_run):
    jm, _, jl, pm, _, pl = fp32_run
    np.testing.assert_allclose(pl, jl, rtol=0, atol=1e-5)
    assert pl[-1] < pl[0] - 1.0                  # the batch is learned
    want = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0,
                                   atol=1e-4, err_msg=name)


def test_o2_loss_curve_matches_jax(o2_run):
    jm, jo, jl, pm, po, pl = o2_run
    np.testing.assert_allclose(pl, jl, rtol=0, atol=3.2e-2)
    assert pl[-1] < pl[0]
    # fp32 masters of the bf16 parameters; the JAX optimizer keys them
    # by parameter name, or by position when the name is empty
    keys = {n: p.name or f"param_{i}"
            for i, (n, p) in enumerate(jm.named_parameters())}
    jmaster = {n: np.asarray(jo._master_weights[k]) for n, k in keys.items()
               if k in jo._master_weights}
    assert jmaster
    checked = 0
    for name, p in pm.named_parameters():
        master = po.state[p].get("master")
        assert (master is None) == (name not in jmaster), name
        if master is not None:
            diff = np.abs(master.numpy() - jmaster[name])
            assert diff.max() <= 6 * LR, name
            assert np.median(diff) <= 5e-5, name
            checked += 1
    assert checked == len(jmaster)


def test_o2_decorate_keeps_rms_norm_fp32_and_masters_the_rest(o2_run):
    _, _, _, pm, po, _ = o2_run
    for name, p in pm.named_parameters():
        norm = "layernorm" in name or name == "llama.norm.weight"
        assert p.dtype == (torch.float32 if norm else torch.bfloat16), name
        st = po.state[p]
        if norm:
            assert "master" not in st, name
        else:
            assert torch.equal(p.detach(), st["master"].to(torch.bfloat16))
    # the rope tables are buffers, untouched by the cast
    att = pm.llama.layers[0].self_attn
    assert att._cos.dtype == att._sin.dtype == torch.float32


def test_criterion_matches_jax():
    """Mean over valid tokens only; fp32, atol 1e-6 against the JAX
    criterion."""
    rs = np.random.RandomState(4)
    logits = rs.randn(2, 5, 7).astype(np.float32)
    labels = rs.randint(0, 7, (2, 5)).astype(np.int64)
    labels[0, 1] = labels[1, 3] = -100
    got = LlamaPretrainingCriterion()(torch.from_numpy(logits),
                                      torch.from_numpy(labels))
    want = JaxCriterion()(Tensor(logits), Tensor(labels))
    np.testing.assert_allclose(got.item(), float(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_head_carries_and_forward_matches_jax(tied):
    """The untied ``lm_head_weight`` and the tied head (the embedding)
    carry across by name; the eval forward's logits then agree, fp32, atol
    1e-5."""
    jm, pm = _carried(tie_word_embeddings=tied)
    names = [n for n, _ in pm.named_parameters()]
    assert ("lm_head_weight" in names) == (not tied)
    ids, _ = _batch(2)
    want = np.asarray(jm(Tensor(ids))._data)
    got = pm(torch.from_numpy(ids)).numpy()
    assert got.shape == (2, 16, 256)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_recompute_gives_the_same_gradients():
    ids, labels = (torch.from_numpy(a) for a in _batch(3))
    grads = []
    for recompute in (False, True):
        m = LlamaForCausalLM(llama_config("tiny", use_recompute=recompute),
                             device="cpu", seed=5).train()
        m.loss_fn(m(ids), labels).backward()
        grads.append([p.grad.clone() for p in m.parameters()])
    for g0, g1 in zip(*grads):
        assert torch.equal(g0, g1)


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="sequence_parallel"):
        LlamaForCausalLM(llama_config("tiny", sequence_parallel=True),
                         device="cpu")
    m = LlamaForCausalLM(llama_config("tiny"), device="cpu")
    ids = torch.zeros(1, 4, dtype=torch.long)
    # the dense and the paged KV cache and beam search are ported
    # (tests/test_torch_decode_loop.py, tests/test_torch_paged_generate.py);
    # a past of neither kind is refused.  The paged serving step is ported
    # too (tests/test_torch_llama_serving.py): it reads the layers' views
    with pytest.raises(TypeError, match="PagedLayerView"):
        m(ids, past=[None, None])
    with pytest.raises(TypeError, match="PagedLayerView"):
        m.llama.layers[0].self_attn(torch.zeros(1, 4, 64), past=object())
    params, step = m.build_ragged_decode_step()
    assert len(params["layers"]) == 2 and callable(step)


def test_default_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: device=None is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(llama_config("tiny"))
