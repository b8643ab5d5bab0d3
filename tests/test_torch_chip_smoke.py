"""The cross-checks of ``chip_smoke.py`` (phases 6b and 8b) run on the CPU
at tiny size: one O2 step of the port's trainer against the step that
``chip_smoke.py`` composes from the plain versions, and the fault controls
its gradient check must catch.  Phase 10's checks run the same way: the
first decode step's logits against the dense forward, with the fault
control (the step's attention one position short) that must fail it, and
the eager-vs-compiled and EOS checks on a tiny LLaMA.

On the CPU every wrapper takes its plain version, so the sound readings
are those of two compositions of the same plain ops: exact here (0) up to
1e-6.  The fault controls (a norm's dx without its mean terms, rope
rotated the other way) must exceed ``GRAD_REL_TOL`` at this size too; the
unrounded-table control is a bf16-level difference that the card's limit
separates at full width only, so here it is read, not gated.  ``fail`` is
replaced by a recorder, so every reading prints and every check's verdict
is asserted.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.models import gpt as tgpt  # noqa: E402
from paddle_tpu_torch.models import llama as tllama  # noqa: E402

SOUND_TOL = 1e-6


@pytest.fixture
def failures(monkeypatch):
    """chip_smoke's cross-checks on the CPU at tiny size: the models on
    the CPU, the LLaMA preset MHA (the plain composition repeats no kv
    heads), and each failed check recorded instead of ending the
    process."""
    got = []
    monkeypatch.setattr(cs, "fail", got.append)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.Tensor, "cuda", lambda self, *a, **k: self)
    monkeypatch.setattr(cs, "LLAMA_PRESET", "tiny")
    monkeypatch.setattr(cs, "LLAMA_BATCH", 2)
    monkeypatch.setattr(cs, "LLAMA_SEQ", 32)
    monkeypatch.setattr(cs, "llama_config", lambda name, **kw:
                        tllama.llama_config(name, num_kv_heads=4, **kw))
    monkeypatch.setattr(cs, "LlamaForCausalLM", lambda cfg, seed:
                        tllama.LlamaForCausalLM(cfg, device="cpu",
                                                seed=seed))
    monkeypatch.setattr(cs, "TRAIN_BATCH", 2)
    monkeypatch.setattr(cs, "TRAIN_SEQ", 32)
    monkeypatch.setattr(cs, "gpt_config", lambda name, **kw:
                        tgpt.gpt_config("tiny", **kw))
    monkeypatch.setattr(cs, "GPTForPretraining", lambda cfg, seed:
                        tgpt.GPTForPretraining(cfg, device="cpu",
                                               seed=seed))
    return got


def _readings(out, what):
    """The worst readings printed for ``what`` ("gradients'" for the sound
    step, "control NAME" for a control)."""
    return [float(line.split("worst ")[1].split()[0])
            for line in out.splitlines() if what in line]


def test_llama_cross_check_holds_and_sees_its_fault_controls(failures,
                                                              capsys):
    cs.llama_cross_check()
    out = capsys.readouterr().out
    print(out)
    assert _readings(out, "gradients' relative error |g_k") == \
        [pytest.approx(0.0, abs=SOUND_TOL)]
    for fault in ("rms_dx", "rope_sign"):
        (worst,) = _readings(out, f"control {fault}:")
        assert worst > cs.GRAD_REL_TOL, fault
    (tables,) = _readings(out, "control tables_fp32:")
    assert 0 < tables
    assert failures == [] or (len(failures) == 1
                              and "tables_fp32" in failures[0]), failures


def test_gpt_cross_check_holds_and_sees_its_fault_control(failures,
                                                          capsys):
    cs.cross_check()
    out = capsys.readouterr().out
    print(out)
    assert _readings(out, "gradients' relative error |g_k") == \
        [pytest.approx(0.0, abs=SOUND_TOL)]
    (worst,) = _readings(out, "control ln_dx:")
    assert worst > cs.GRAD_REL_TOL
    assert failures == [], failures


@pytest.fixture
def tiny_llama():
    model = tllama.LlamaForCausalLM(tllama.llama_config("tiny"),
                                    device="cpu", seed=0)
    ids = torch.from_numpy(np.random.RandomState(2).randint(0, 256, (2, 16)))
    return model, ids


def test_step_logit_check_holds_and_sees_its_fault_control(failures,
                                                           tiny_llama,
                                                           capsys):
    """The decode step (plain versions here) equals the dense forward over
    prompt + token to fp32 rounding; leaving the appended row out of the
    step's attention fails the same check."""
    err, ctrl = cs.step_logit_check(*tiny_llama)
    print(capsys.readouterr().out)
    assert err < 1e-5 < cs.STEP_LOGITS_TOL < ctrl
    assert failures == []


def test_decode_phase_checks_hold_on_the_cpu(failures, tiny_llama, capsys):
    model, ids = tiny_llama
    new = 10
    greedy = cs.generation.decode_loop(model, ids, max_new_tokens=new)
    assert cs.eager_agreement(model, ids, greedy, 6) > 0
    cs.eos_check(model, ids, greedy, new)
    print(capsys.readouterr().out)
    assert failures == []
