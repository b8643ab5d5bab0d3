"""``paddle_tpu_torch.save`` / ``load`` (``framework/io.py``) against the
JAX package's ``paddle.save`` / ``paddle.load``.

* A tiny GPT's ``state_dict`` saved by ``paddle_tpu.save`` loads with
  the port's ``load`` (its unpickler maps the JAX payload class to the
  port's, importing nothing of ``paddle_tpu``); carried into the port's
  GPT through ``load_paddle_tpu_state``, the weights give the JAX
  model's logits (fp32, ``atol 1e-5``).
* The JAX package's bf16 tensors (``ml_dtypes`` arrays) load as torch
  bf16 bit for bit; without ``ml_dtypes`` such a file raises an
  ``ImportError`` naming it.
* Round trips through the port's own ``save`` / ``load`` are exact:
  fp32, bf16 (stored as its 16-bit words), int64 and bool, nested in
  dicts, lists and tuples, a parameter as a parameter, file names and
  file objects, ``return_numpy``.
* ``save_group_sharded_model``'s files are the port's ``save``'s.
"""
import io
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu.models import GPTForPretraining as JaxGPT
from paddle_tpu.models import gpt_config as jax_gpt_config

import paddle_tpu_torch as ptt
from paddle_tpu_torch.models import (GPTForPretraining, gpt_config,
                                     load_paddle_tpu_state)

_CFG = dict(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)


def test_jax_saved_gpt_state_loads_and_gives_the_jax_logits(tmp_path):
    jpaddle.seed(3)
    jm = JaxGPT(jax_gpt_config("tiny", **_CFG))
    jm.eval()
    path = str(tmp_path / "gpt.pdparams")
    jpaddle.save(jm.state_dict(), path)
    state = ptt.load(path)
    assert set(state) == set(jm.state_dict())
    assert all(isinstance(v, torch.Tensor) for v in state.values())
    pm = GPTForPretraining(gpt_config("tiny", **_CFG), device="cpu")
    pm.eval()
    load_paddle_tpu_state(pm, {k: v.detach().numpy()
                               for k, v in state.items()})
    ids = np.random.RandomState(0).randint(0, 512, (2, 16)).astype(np.int64)
    want = np.asarray(jm(jpaddle.to_tensor(ids))._data)
    with torch.no_grad():
        got = pm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the numpy form is the same arrays
    arrays = ptt.load(path, return_numpy=True)
    for k, v in jm.state_dict().items():
        np.testing.assert_array_equal(arrays[k], np.asarray(v._data))


def _jax_bf16_file(tmp_path):
    t = jpaddle.to_tensor(np.linspace(-3, 3, 12, dtype=np.float32)
                          .reshape(3, 4)).astype("bfloat16")
    path = str(tmp_path / "bf16.pdparams")
    jpaddle.save({"w": t, "step": 5}, path)
    return path, np.asarray(t._data).view(np.uint16)


def test_jax_bf16_loads_bit_for_bit(tmp_path):
    path, words = _jax_bf16_file(tmp_path)
    got = ptt.load(path)
    assert got["step"] == 5 and got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["w"].view(torch.int16).numpy()
                                  .view(np.uint16), words)


def test_missing_ml_dtypes_is_named(tmp_path, monkeypatch):
    path, _ = _jax_bf16_file(tmp_path)
    for name in [m for m in sys.modules if m.split(".")[0] == "ml_dtypes"]:
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError, match="ml_dtypes"):
        ptt.load(path)


def test_port_round_trips_are_exact(tmp_path):
    g = torch.Generator().manual_seed(0)
    p = torch.nn.Parameter(torch.randn(4, 3, generator=g))
    obj = {"fp32": torch.randn(5, generator=g),
           "bf16": torch.randn(2, 3, generator=g).to(torch.bfloat16),
           "ids": torch.arange(6).reshape(2, 3),
           "mask": torch.tensor([True, False, True]),
           "param": p, "nested": [torch.ones(2), (torch.zeros(1), 3)],
           "meta": {"lr": 1e-3, "name": "x"}}
    path = str(tmp_path / "sub" / "obj.pdparams")
    ptt.save(obj, path)
    buf = io.BytesIO()
    ptt.save(obj, buf)
    buf.seek(0)
    for got in (ptt.load(path), ptt.load(buf)):
        for k in ("fp32", "bf16", "ids", "mask"):
            assert got[k].dtype == obj[k].dtype, k
            assert torch.equal(got[k], obj[k]), k
        assert isinstance(got["param"], torch.nn.Parameter)
        assert got["param"].requires_grad and torch.equal(got["param"], p)
        assert isinstance(got["nested"], list)
        assert torch.equal(got["nested"][0], torch.ones(2))
        assert isinstance(got["nested"][1], tuple)
        assert got["nested"][1][1] == 3 and got["meta"] == obj["meta"]
    arrays = ptt.load(path, return_numpy=True)
    assert arrays["bf16"].dtype == np.uint16
    np.testing.assert_array_equal(
        arrays["bf16"], obj["bf16"].view(torch.int16).numpy().view(np.uint16))


def test_unsupported_configs_raise(tmp_path):
    with pytest.raises(NotImplementedError):
        ptt.save({}, str(tmp_path / "x"), use_binary_format=True)
    ptt.save({}, str(tmp_path / "x"))
    with pytest.raises(NotImplementedError):
        ptt.load(str(tmp_path / "x"), keep_name_table=True)


def test_group_sharded_save_writes_through_paddle_save(tmp_path):
    """``save_group_sharded_model`` in a world of one writes the model's
    weights and the optimizer's gathered state with ``save``."""
    import os

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed.sharding import (
        group_sharded_parallel, save_group_sharded_model)
    dist.init_parallel_env(device="cpu")
    try:
        m = torch.nn.Linear(4, 4)
        model, opt, _ = group_sharded_parallel(
            m, optimizer.AdamW(parameters=m.parameters()), "os_g")
        model(torch.randn(2, 4)).sum().backward()
        opt.step()
        save_group_sharded_model(model, str(tmp_path / "out"), opt)
        state = ptt.load(os.path.join(tmp_path, "out", "model.pdmodel"))
        assert torch.equal(state["weight"], m.weight.detach())
        ostate = ptt.load(os.path.join(tmp_path, "out", "model.pdopt"))
        assert torch.equal(ostate["state"][0]["moment1"],
                           opt.state_dict()["state"][0]["moment1"])
    finally:
        dist.destroy_process_group()
