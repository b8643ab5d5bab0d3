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


# ---------------------------------------------------------------------------
# phases 11 and 12: K9's cases, the paged main path and beam search
# ---------------------------------------------------------------------------

@pytest.fixture
def tiny_gpt():
    model = tgpt.GPTForPretraining(
        tgpt.gpt_config("tiny", hidden_dropout_prob=0.0,
                        attention_dropout_prob=0.0), device="cpu", seed=0)
    ids = torch.from_numpy(np.random.RandomState(1).randint(0, 512, (2, 16)))
    return model, ids


@pytest.fixture
def no_card_memory(monkeypatch):
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda: 0)


def test_k9_cases_are_the_paged_paths_shapes():
    """Phase 11's "llama" and "gpt" cases are phase 12's decode steps
    midway (page 16, head_dim 128, the pools of build_paged_caches), and
    the kernels line names the JAX function K9 replaces."""
    llama = tllama.llama_config(cs.DECODE_PRESET)
    gpt = tgpt.gpt_config("gpt3-1.3B")
    for case, cfg, shape in (("llama", llama, cs.DECODE),
                             ("gpt", gpt, cs.PAGED_GPT)):
        nh, nkv, lengths, ppseq, dtype = cs.K9_CASES[case]
        assert (nh, nkv) == (cfg.num_heads,
                             getattr(cfg, "num_kv_heads", cfg.num_heads))
        assert cfg.hidden_size // cfg.num_heads == cs.HD
        assert lengths == [shape["prompt"] + shape["new"] // 2] \
            * shape["batch"]
        assert ppseq * cs.K9_PAGE == shape["prompt"] + shape["new"]
        assert dtype == torch.float32
    assert 0 in cs.K9_CASES["ragged"][2]
    with open(os.path.join(os.path.dirname(cs.__file__), "paddle_tpu", "ops",
                           "paged_attention.py")) as f:
        line = f.read().splitlines()[70]
    assert line.startswith("def paged_attention(")
    assert 'replaces="paddle_tpu/ops/paged_attention.py:71"' in \
        open(cs.__file__).read()


@pytest.mark.parametrize("name", ["llama", "gpt"])
def test_paged_step_check_holds_and_sees_its_fault_control(
        failures, tiny_llama, tiny_gpt, name, capsys):
    """The first paged step (plain versions here) equals the dense forward
    over prompt + token to fp32 rounding; the tables' lengths one short
    fail the same check."""
    model, ids = tiny_llama if name == "llama" else tiny_gpt
    err, ctrl = cs.paged_step_check(name, model, ids)
    print(capsys.readouterr().out)
    assert err < 1e-5 < cs.STEP_LOGITS_TOL < ctrl
    assert failures == []


def test_paged_main_path_checks_hold_on_the_cpu(failures, tiny_llama,
                                                no_card_memory, capsys):
    """Phase 12's LLaMA path at tiny size: every check holds but the
    launch count, which no plain version moves."""
    model, ids = tiny_llama
    layers = model.config.num_layers
    eager, margin = cs.eager_tokens(model, ids, 6)
    got = cs.paged_main_path("llama paged", model, ids, 10, layers,
                             {"rms_fwd": 2 * layers + 1},
                             {"flash_fwd": layers, "rope": 2 * layers},
                             eager, margin)
    print(capsys.readouterr().out)
    assert len(failures) == 1 and "launches" in failures[0], failures
    assert got["compared"] > 0 and got["steps"] == 9
    assert got["host_reads"] == 0 and got["table_copies"] == 0


def test_beam_phase_checks_hold_on_the_cpu(failures, tiny_gpt, monkeypatch,
                                           capsys):
    """Phase 12's beam search at tiny size: one beam is greedy, the carried
    scores equal their recomputation, and skipping the cache reorder is
    caught."""
    model, _ = tiny_gpt
    monkeypatch.setattr(cs, "BEAM", dict(cs.BEAM, prompt=16, new=12))
    got = cs.beam_main_path("gpt beam", model, require_reorder=True)
    print(capsys.readouterr().out)
    assert failures == []
    assert got["score_err"] < 1e-5 and got["rows_moved"] > 0
    assert got["control_err"] > cs.STEP_LOGITS_TOL
