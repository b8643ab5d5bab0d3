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
import time

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


def test_k1_cases_are_the_training_paths_shapes():
    """Phase 5's "main" and "llama" cases are the GPT and LLaMA training
    steps' attention (batch x heads, seq, head_dim, bf16, causal), every
    older case stays, and the bf16 tensor-core backward's edges are there:
    a bottom-right q_offset, a ragged causal S = 1000, D = 64 and a D
    that is not a multiple of 8."""
    for case, cfg, b, s in (
            ("main", tgpt.gpt_config("gpt3-1.3B"), cs.TRAIN_BATCH,
             cs.TRAIN_SEQ),
            ("llama", tllama.llama_config(cs.LLAMA_PRESET), cs.LLAMA_BATCH,
             cs.LLAMA_SEQ)):
        bh, sq, sk, n_rep, causal, dtype, d = cs.K1_CASES[case]
        assert (bh, sq, sk, causal, dtype) == (b * cfg.num_heads, s, s, True,
                                               torch.bfloat16)
        assert n_rep == cfg.num_heads // getattr(cfg, "num_kv_heads",
                                                 cfg.num_heads)
        assert d == cfg.hidden_size // cfg.num_heads
    assert {"causal-bf16", "causal-fp32", "full-bf16", "full-fp32",
            "q_offset-fp32", "gqa4-bf16"} <= set(cs.K1_CASES)
    bf16 = [c for c in cs.K1_CASES.values() if c[5] == torch.bfloat16]
    assert cs.K1_CASES["q_offset-bf16"] == (16, 512, 2048, 1, True,
                                            torch.bfloat16, 128)
    assert any(c[1] == c[2] == 1000 and c[4] for c in bf16)
    assert any(c[6] == 64 for c in bf16)
    assert any(c[6] % 8 for c in bf16)
    # one query row against 2048 keys at q_offset 2047: one live warp in
    # the forward's query tile
    bh, sq, sk, n_rep, causal, dtype, d = cs.K1_CASES["q1-bf16"]
    assert (sq, sk, causal, dtype, d) == (1, 2048, True, torch.bfloat16, 128)


def test_k7_cases_keep_the_old_shapes_and_straddle_the_page_splits():
    """Phase 3 keeps its mixed, decode and full-context cases and adds a
    decode whose lengths straddle the page splits the wrapper picks on an
    H100 (132 SMs): a run of fewer live pages than splits, one page, a
    last page cut mid-way, at every head layout it runs at (MHA 16/16,
    GQA 32/8); llama2-7b's heads (MHA 32/32, served in phases 4c-4e) run
    the fp32 decode case only."""
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    assert {"mixed", "decode", "decode-2048"} <= set(cs.CASES)
    assert set(cs.HEADS) == {"mha", "gqa", "llama"}
    assert cs.HEADS["llama"] == (32, 32)
    assert cs.K7_LLAMA_CASES == {("decode", torch.float32)}
    spec = cs.CASES["decode-split"]
    assert spec["q_lens"] == [1] * 8 and spec["q_width"] == 1
    ps = 16
    ppseq = -(-max(spec["kv_lens"]) // ps)
    for nh, nkv in (cs.HEADS["mha"], cs.HEADS["gqa"]):
        groups = -(-nh // nkv // rpa._ROWS) * nkv
        dev = torch.device("cuda", 0)
        rpa._sm_count[dev] = 132
        try:
            splits = rpa._splits(groups, 8, ppseq, dev)
        finally:
            del rpa._sm_count[dev]
        assert splits > 1
        live = [-(-n // ps) for n in spec["kv_lens"]]
        per = [-(-n // splits) for n in live]
        assert any(n < splits for n in live)             # empty runs
        assert any(p == 1 for p in per)
        assert any(n % ps and n > ps for n in spec["kv_lens"])
        assert any(n % p for n, p in zip(live, per))     # a short last run


def test_sass_check_reads_the_bf16_backward_instantiations():
    """The SASS check counts HMMA / HGMMA per function and picks out the
    head_dim instantiations of the three tensor-core templates (mangled
    ``<len><name>I``: the bf16 forward and both backward kernels), not
    the fp32 kernels, whose names extend them."""
    ns = "_ZN12_GLOBAL__N_1"
    text = "\n".join([
        f"\tFunction : {ns}19flash_bwd_dq_kernelILi128EEEvPK13__nv_bf",
        "\t/*0100*/  HMMA.16816.F32.BF16 R4, R8, R12, R4 ;",
        "\t/*0110*/  HMMA.16816.F32.BF16 R16, R8, R14, R16 ;",
        f"\tFunction : {ns}19flash_bwd_dq_kernelILi64EEEvPK13__nv_bf",
        "\t/*0100*/  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], R24 ;",
        f"\tFunction : {ns}24flash_bwd_dq_fp32_kernelIfLi128EEEvPKT_",
        "\t/*0100*/  FFMA R1, R2, R3, R1 ;",
        f"\tFunction : {ns}20flash_bwd_dkv_kernelILi128EEEvPK13__nv_bf",
        "\t/*0100*/  FFMA R1, R2, R3, R1 ;",
        f"\tFunction : {ns}16flash_fwd_kernelILi128EEEvPK13__nv_bfloat16",
        "\t/*0100*/  HMMA.16816.F32.BF16 R4, R8, R12, R4 ;",
        "\t/*0110*/  HMMA.16816.F32.BF16 R16, R8, R14, R16 ;",
        "\t/*0120*/  HMMA.16816.F32.BF16 R20, R8, R14, R20 ;",
        f"\tFunction : {ns}21flash_fwd_fp32_kernelILi64EEEvPKfS2_S2_Pf",
        "\t/*0100*/  FFMA R1, R2, R3, R1 ;"])
    counts = cs.parse_sass(text)
    assert sorted(counts.values()) == [0, 0, 0, 1, 2, 3]
    assert cs.tc_instances(counts, "flash_bwd_dq_kernel") == {128: 2, 64: 1}
    assert cs.tc_instances(counts, "flash_bwd_dkv_kernel") == {128: 0}
    assert cs.tc_instances(counts, "flash_fwd_kernel") == {128: 3}
    assert "flash_fwd_kernel" in cs.TC_KERNELS
    with open(os.path.join(os.path.dirname(cs.__file__), "paddle_tpu_torch",
                           "ops", "csrc", "flash_attention.cu")) as f:
        src = f.read()
    for kernel in cs.TC_KERNELS:
        assert f"\n{kernel}(const bf16*" in src


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


# ---------------------------------------------------------------------------
# phases 13 and 14: K8's cases, BART training, its cross-check, generate
# ---------------------------------------------------------------------------

BART_TINY = dict(vocab_size=64, d_model=32, encoder_layers=2,
                 decoder_layers=2, encoder_attention_heads=4,
                 decoder_attention_heads=4, encoder_ffn_dim=64,
                 decoder_ffn_dim=64, max_position_embeddings=64)


@pytest.fixture
def tiny_bart(failures, monkeypatch):
    """chip_smoke's BART phases at the tiny config on the CPU, batch 2 x
    32 + 32."""
    from paddle_tpu_torch.models import bart as tbart
    monkeypatch.setattr(cs, "BartConfig", lambda **kw: tbart.BartConfig(
        **dict(BART_TINY, **kw)))
    monkeypatch.setattr(cs, "BartForConditionalGeneration",
                        lambda cfg, seed: tbart.BartForConditionalGeneration(
                            cfg, device="cpu", seed=seed))
    monkeypatch.setattr(cs, "BART_BATCH", 2)
    monkeypatch.setattr(cs, "BART_SEQ", 32)
    return tbart


def test_k8_cases_and_bart_counts_are_the_paths():
    """Phase 13's main case is phase 14's loss (batch x decoder tokens,
    bart-base's vocabulary, fp32); phase 14's per-step launches at
    bart-base are 32 norms and 259 AdamW updates (one per trainable
    tensor); the kernels line names the JAX functions K8 replaces."""
    from paddle_tpu_torch.models.bart import BartConfig
    n, v, dtype, kind = cs.K8_CASES["main"]
    assert (n, v, dtype, kind) == (cs.BART_BATCH * cs.BART_SEQ,
                                   BartConfig().vocab_size, torch.float32,
                                   "mixed")
    per = cs.bart_per_step(BartConfig())
    assert {k: c for k, c in per.items() if c} == dict(
        ce_fwd=1, ce_bwd=1, ln_fwd=32, ln_bwd_dx=32, adamw=259)
    root = os.path.dirname(cs.__file__)
    with open(os.path.join(root, "paddle_tpu", "ops", "pallas",
                           "softmax_ce.py")) as f:
        lines = f.read().splitlines()
    assert lines[64].startswith("def _fwd(")
    assert lines[82].startswith("def _bwd(")
    src = open(cs.__file__).read()
    assert '("softmax_ce_fwd", "fwd", ":65", "ce_fwd")' in src
    assert '("softmax_ce_bwd", "bwd", ":83", "ce_bwd")' in src


def test_k2_cases_are_the_paths_shapes():
    """Phase 5's K2 cases hold the GPT training step's LayerNorm (batch x
    seq rows of GPT-3 1.3B's width, fp32: O2 keeps LayerNorm in fp32),
    bart-base's, the 8 rows of a GPT decode step (phases 12 and 16), an
    odd width and a view one element past 16-byte alignment (both the
    kernel's generic route), and the mean offset; the kernels line names
    the JAX functions K2a and K2b replace."""
    from paddle_tpu_torch.models.bart import BartConfig
    from paddle_tpu_torch.ops import layer_norm as tln
    h = tgpt.gpt_config("gpt3-1.3B").hidden_size
    cases = cs.K2_CASES
    f32 = torch.float32
    assert cases["float32"] == (cs.TRAIN_BATCH * cs.TRAIN_SEQ, h, f32, f32,
                                "randn")
    assert cases["bart"] == (cs.BART_BATCH * cs.BART_SEQ,
                             BartConfig().d_model, f32, f32, "randn")
    assert cases["decode"] == (cs.PAGED_GPT["batch"], h, f32, f32, "randn")
    odd = [c for c in cases.values() if c[1] % 2]
    assert {c[2] for c in odd} == {f32, torch.bfloat16}
    assert all(c[1] not in tln.VECTOR_WIDTHS for c in odd)
    assert (cs.TRAIN_BATCH * cs.TRAIN_SEQ, h, f32, f32, "unaligned") in \
        cases.values()
    assert (cs.TRAIN_BATCH * cs.TRAIN_SEQ, h, f32, f32, "offset") in \
        cases.values()
    # every width of the vector route
    assert {c[1] for c in cases.values()} >= set(tln.VECTOR_WIDTHS)
    assert set(cs.AB_K2_CASES) <= set(cases)
    root = os.path.dirname(cs.__file__)
    with open(os.path.join(root, "paddle_tpu", "ops", "pallas",
                           "layer_norm.py")) as f:
        lines = f.read().splitlines()
    assert lines[57].startswith("def _fwd(")
    assert lines[79].startswith("def _bwd_dx(")
    src = open(cs.__file__).read()
    assert '("layer_norm_fwd", "fwd", ":58", "ln_fwd")' in src
    assert '("layer_norm_bwd_dx", "dx", ":80", "ln_bwd_dx")' in src


def test_k2_mean_offset_control_fails_on_the_cpu(failures, capsys):
    """At phase 5's mean offset the plain version passes `check_close`
    against the float64 formula, and the one-pass formula (E[x²] -
    mean² in fp32) fails it against the plain version: the case would
    catch a one-pass kernel."""
    from paddle_tpu_torch.ops import layer_norm as tln
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(64, 2048).astype(np.float32)
                         + cs.K2_OFFSET)
    w = torch.from_numpy(1 + 0.1 * rs.randn(2048).astype(np.float32))
    b = torch.from_numpy(0.1 * rs.randn(2048).astype(np.float32))
    xd, wd, bd = x.double(), w.double(), b.double()
    m = xd.mean(dim=-1, keepdim=True)
    exact = (xd - m) * torch.rsqrt((xd - m).square().mean(
        dim=-1, keepdim=True) + 1e-5) * wd + bd
    assert cs.close_excess(tln.layer_norm_ref(x, w, b, 1e-5), exact,
                           torch.float32) <= 0
    cs.check_close("plain", tln.layer_norm_ref(x, w, b, 1e-5), exact,
                   torch.float32)
    excess = cs.mean_offset_control(x, w, b)
    print(capsys.readouterr().out)
    assert excess > 0
    assert failures == []
    # without the offset the one-pass formula passes: it is the offset
    # that the check needs to see the fault
    x0 = x - cs.K2_OFFSET
    assert cs.close_excess(cs.one_pass_layer_norm(x0, w, b),
                           tln.layer_norm_ref(x0, w, b, 1e-5),
                           torch.float32) <= 0


def test_bart_train_main_path_holds_on_the_cpu(tiny_bart, failures,
                                               no_card_memory, capsys):
    """Phase 14 at tiny size: finite, falling losses and the frozen bias
    kept; only the launch counts fail, which no plain version moves."""
    model, _ = cs.bart_train_main_path()
    print(capsys.readouterr().out)
    assert failures and all("launches" in f for f in failures), failures
    assert float(model.final_logits_bias.abs().sum()) == 0.0


def test_bart_cross_check_holds_and_sees_its_fault_control(tiny_bart,
                                                           failures,
                                                           capsys):
    """Phase 14b at tiny size: the plain composition equals the port's
    step (exactly here, where both take the plain versions), and the
    ignored-rows control exceeds the gradient limit."""
    cs.bart_cross_check()
    out = capsys.readouterr().out
    print(out)
    assert _readings(out, "gradients' relative error |g_k") == \
        [pytest.approx(0.0, abs=SOUND_TOL)]
    (worst,) = _readings(out, "control ce_ignored_grad:")
    assert worst > cs.BART_GRAD_REL_TOL
    assert failures == [], failures


def test_bart_generate_checks_hold_on_the_cpu(tiny_bart, failures,
                                              monkeypatch, capsys):
    """Phase 14c at tiny size with weights that pick varied tokens: the
    greedy tokens equal the dense argmax, the beam scores their
    recomputation, the forced eos the last slot (the launch counts, which
    no plain version moves, are stubbed)."""
    model = cs.BartForConditionalGeneration(cs.BartConfig(), seed=0)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 2:
                p.normal_(0.0, 2.0 / p.shape[0] ** 0.5,
                          generator=torch.Generator().manual_seed(p.numel()))
    monkeypatch.setattr(cs, "BART_GEN", dict(batch=2, new=10, num_beams=3))
    monkeypatch.setattr(cs, "counts", lambda: dict(
        {k: 0 for k in cs.PER_STEP}, ln_fwd=1))
    got = cs.bart_generate_main_path(model)
    print(capsys.readouterr().out)
    assert failures == [], failures
    assert got["greedy"]["compared"] > 0
    assert got["beam"]["score_err"] < 1e-5


def test_k6d_cases_are_the_program_paths_shapes():
    """Phase 15's first cases are the shapes phase 16 gives K6d: GPT-3
    1.3B's qkv, fc1 and tied head, LLaMA-2 7B's head, at batch 8."""
    gpt, llama = tgpt.gpt_config("gpt3-1.3B"), tllama.llama_config(
        "llama2-7b")
    h = gpt.hidden_size
    assert cs.K6D_CASES["gpt_qkv"][1:6] == ((8, 1), h, 3 * h, False, True)
    assert cs.K6D_CASES["gpt_fc1"][1:6] == ((8, 1), h,
                                            gpt.intermediate_size, False,
                                            True)
    assert cs.K6D_CASES["gpt_head"][1:6] == ((8, 1), h, gpt.vocab_size,
                                             True, False)
    assert cs.K6D_CASES["llama_head"][1:6] == (
        (8, 1), llama.hidden_size, llama.vocab_size, True, False)
    assert max(int(np.prod(c[1])) for c in cs.K6D_CASES.values()) == \
        cs.fd.NORM_MLP_MAX_ROWS


@pytest.mark.parametrize("name", ["gpt", "llama"])
def test_program_main_path_checks_hold_on_the_cpu(failures, name, capsys):
    """Phase 16's checks on tiny models: the claims, the fetches of both
    replays against each other and the eager step, and (GPT) the control
    without the norm's bias, which must fail the fetch check.  On the CPU
    nothing launches, so every launch count is 0."""
    rs = np.random.RandomState(16)
    if name == "gpt":
        model = tgpt.GPTForPretraining(tgpt.gpt_config(
            "tiny", hidden_dropout_prob=0.0, attention_dropout_prob=0.0),
            device="cpu", seed=0)
        with torch.no_grad():
            for mod in model.modules():
                if isinstance(mod, tgpt.LayerNorm):
                    mod.bias.copy_(torch.from_numpy(
                        rs.randn(*mod.bias.shape).astype("float32")) * 0.1)
        chains = {"layer_norm->linear": 4, "layer_norm->matmul": 1}
        weights = {"attn.qkv_proj.weight": 2, "mlp.fc1.weight": 2,
                   "embeddings.word_embeddings.weight": 1}
        control = (lambda real: (lambda x, nw, nb, w, bias=None, **kw:
                                 real(x, nw, None, w, bias, **kw)))
    else:
        model = tllama.LlamaForCausalLM(tllama.llama_config("tiny"),
                                        device="cpu", seed=0)
        chains, weights, control = ({"rms_norm->matmul": 1},
                                    {"lm_head_weight": 1}, None)
    vocab = model.config.vocab_size
    ids = torch.from_numpy(rs.randint(0, vocab, (2, 16)))
    res = cs.program_main_path(f"{name} program", model, ids, chains,
                               weights, {}, {}, control=control)
    print(capsys.readouterr().out)
    assert failures == [], failures
    assert res["err_optimized_vs_unoptimized"] < 1e-5
    assert res["err_unoptimized_vs_eager"] == 0.0
    assert res["reduction_pct"] >= 10.0
    if control is not None:
        assert res["control_err"] > cs.PROGRAM_TOL["atol"]


def test_k6c_and_k6d_cases_take_their_routes():
    """Phase 9's K6c cases are the decode paths' shapes (llama2-7b's and
    GPT-3 1.3B's MLPs at batch 8, bf16, 33 and 64 rows: the gate's limit)
    and phase 15's K6d cases the program paths'; every one takes the
    stream route but ``odd`` and ``odd_t``, which take the generic one.
    The A/B cases are phase 9's and 15's main-path cases, and the weight
    copies a time rotates over pass twice the L2."""
    from paddle_tpu_torch.ops import fused_decode as tfd
    gpt, llama = tgpt.gpt_config("gpt3-1.3B"), tllama.llama_config(
        "llama2-7b")
    f32 = torch.float32
    assert cs.K6C_CASES["llama"] == ("rms_norm", "silu", llama.hidden_size,
                                     llama.intermediate_size, f32, 8)
    assert cs.K6C_CASES["gpt"] == ("layer_norm", "gelu_tanh",
                                   gpt.hidden_size, gpt.intermediate_size,
                                   f32, 8)
    assert {c[5] for c in cs.K6C_CASES.values()} == {8, 33, 64}
    assert max(c[5] for c in cs.K6C_CASES.values()) == \
        tfd.NORM_MLP_MAX_ROWS
    for kind, act, h, inter, dtype, rows in cs.K6C_CASES.values():
        def m(*shape):
            return torch.empty(*shape, dtype=dtype, device="meta")
        wg = m(h, inter) if kind == "rms_norm" else None
        assert tfd.norm_mlp_route(m(rows, h), m(h, inter), m(inter, h),
                                  wg) == "stream"
    for name, (kind, lead, h, n, transposed, bias, dtype) in \
            cs.K6D_CASES.items():
        x = torch.empty(*lead, h, dtype=dtype, device="meta")
        w = torch.empty(n, h, dtype=dtype, device="meta").t() \
            if transposed else torch.empty(h, n, dtype=dtype, device="meta")
        want = "generic" if name in cs.K6D_GENERIC else "stream"
        assert tfd.norm_matmul_route(x, w) == want, name
    assert set(cs.K6D_GENERIC) == {"odd", "odd_t"}
    assert set(cs.AB_K6C_CASES) == {"llama", "gpt"}
    assert set(cs.AB_K6D_CASES) == set(cs.K6D_GPT_STEP) | {"llama_head"}
    for nbytes in (33.5e6, 50.3e6, 67.1e6, 134e6, 541e6):
        k = cs.weight_copies(nbytes)
        assert k * nbytes > cs.ROTATE_BYTES >= (k - 1) * nbytes
    assert cs.ROTATE_BYTES >= 2 * 50e6


# ---------------------------------------------------------------------------
# phases 4, 4c, 4d and 4e: serving, the window and HTTP
# ---------------------------------------------------------------------------

TINY_SERVE = dict(lengths=(5, 9, 13, 20, 27, 40), prefix=16, tail=8, new=8,
                  sampled=2, temperature=0.8)


@pytest.fixture
def serving(failures, monkeypatch):
    """Phases 4-4e at tiny size on the CPU: the requests cut to fit
    tiny's 128 positions (the longest 40 + 8), 4 pages of 16 a sequence,
    and K7 and K6c replaced by counting plain versions (one count a
    call, K6c at most 64 rows, as the card's wrappers count their
    launches); a check whose limit is the card's reads at the CPU's
    scale (``LOGITS_TOL`` 1e-4: the sound step reads ~1e-7)."""
    from paddle_tpu_torch.models import generation
    from paddle_tpu_torch.ops import fused_decode as fd
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    monkeypatch.setattr(cs, "SERVE", TINY_SERVE)
    monkeypatch.setattr(cs, "LLAMA_SERVE_PAGES", 4)
    monkeypatch.setattr(cs, "LOGITS_TOL", 1e-4)
    attend, mlp = generation.ragged_paged_attention, fd.norm_mlp

    def counted_attend(*a, **k):
        rpa.launches += 1
        return attend(*a, **k)

    def counted_mlp(x, **k):
        if x.shape[0] <= fd.NORM_MLP_MAX_ROWS:
            fd.launches["norm_mlp"] += 1
        return mlp(x, **k)

    monkeypatch.setattr(generation, "ragged_paged_attention", counted_attend)
    monkeypatch.setattr(fd, "norm_mlp", counted_mlp)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    return failures


def test_serving_phases_hold_on_the_cpu(serving, capsys):
    """Phases 4c (with its logit check and fault control), 4d and 4e on
    a tiny GQA LLaMA: every check passes, the window's tokens equal the
    single step's (greedy and sampled), HTTP's equal the in-process
    run's, K7 runs once per layer per dispatched iteration."""
    model = tllama.LlamaForCausalLM(tllama.llama_config("tiny"),
                                    device="cpu", seed=0)
    got = cs.llama_serve_main_path(model)
    print(capsys.readouterr().out)
    assert serving == []
    single, window = got["single"], got["window"]
    assert got["step_err"] < 1e-5 and got["control_err"] > cs.LOGITS_TOL
    assert single["k7"] == 2 * single["stats"]["steps"] > 0
    st = window["stats"]
    assert st["steps"] > st["dispatches"] == st["host_reads"]
    assert window["k7"] == 2 * (st["steps"] + st["window_idle_iterations"])
    assert window["outs"] == single["outs"]
    assert got["http"]["k7"] > 0
    assert set(window["trace"]) == {"window", "step", "window_ms",
                                    "window_dispatch_ms", "step_ms"}


def test_gpt_serve_and_window_runs_hold_on_the_cpu(serving, tiny_gpt,
                                                   capsys):
    model, _ = tiny_gpt
    prompts, temps = cs.serve_prompts(model.config.vocab_size)
    assert [len(p) for p in prompts] == [5, 9, 13, 20, 27, 40, 24, 24]
    assert prompts[-1][:16] == prompts[-2][:16]
    assert temps.count(0.0) == 7 and temps[2] == 0.8
    engine = cs.ServingEngine(model, **cs.SERVE_ENGINE, device="cpu")
    single = cs.serve_run("main path", engine, prompts, temps, 2,
                          model.config.vocab_size)
    window = cs.window_run("gpt window", model, prompts, temps, single, 2,
                           cs.SERVE_ENGINE)
    print(capsys.readouterr().out)
    assert serving == []
    assert window["outs"] == single["outs"]


def test_serving_checks_fail_on_a_wrong_launch_count(serving, tiny_gpt,
                                                     monkeypatch, capsys):
    """A K7 that counted twice a call, or a window that gave other
    tokens, fails the phase's checks."""
    model, _ = tiny_gpt
    prompts, temps = cs.serve_prompts(model.config.vocab_size)
    from paddle_tpu_torch.models import generation
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    once = generation.ragged_paged_attention

    def twice(*a, **k):
        rpa.launches += 1
        return once(*a, **k)

    monkeypatch.setattr(generation, "ragged_paged_attention", twice)
    engine = cs.ServingEngine(model, **cs.SERVE_ENGINE, device="cpu")
    single = cs.serve_run("main path", engine, prompts, temps, 2,
                          model.config.vocab_size)
    assert any("K7 launches" in f for f in serving)
    serving.clear()
    monkeypatch.setattr(generation, "ragged_paged_attention", once)
    single["outs"][0] = [t + 1 for t in single["outs"][0]]
    cs.window_run("gpt window", model, prompts, temps, single, 2,
                  cs.SERVE_ENGINE)
    capsys.readouterr()
    assert any("other tokens than the single-step run" in f
               for f in serving)


# ---------------------------------------------------------------------------
# phases 4f and 4g: fault containment
# ---------------------------------------------------------------------------

@pytest.fixture
def faulting(serving, no_card_memory, monkeypatch):
    """Phases 4f and 4g at tiny size on the CPU: 32 new tokens (so the
    stall run has the 8 clean steps its recovery needs; LLaMA's pools 5
    pages of 16 a sequence), the watchdog's
    timeout 0.5 s and the stall 1.5 s, and every step paced by a host
    sleep of 15 ms plus 0.1 ms a fed position, so the timing-dependent
    checks (a deadline at half the clean run's wall time, a fitted head
    that tells a prefill from a decode step) read as on the card."""
    from paddle_tpu_torch.serving import engine as tengine
    monkeypatch.setattr(cs, "SERVE", dict(TINY_SERVE, new=32, sampled=0,
                                          temperature=0.0))
    monkeypatch.setattr(cs, "LLAMA_SERVE_PAGES", 5)   # 40 + 32 tokens
    monkeypatch.setattr(cs, "FAULT_TIMEOUT_S", 0.5)
    monkeypatch.setattr(cs, "FAULT_STALL", "serving_step@5=stall:1.5")

    class Paced(tengine.ServingEngine):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            step = self._step_fn

            def paced(params, tok, *rest):
                time.sleep(0.015 + 1e-4 * tok.numel())
                return step(params, tok, *rest)
            self._step_fn = paced

    monkeypatch.setattr(cs, "ServingEngine", Paced)
    return serving


def test_fault_phase_holds_on_the_cpu(faulting, tiny_gpt, capsys):
    """Phase 4f on a tiny GPT after a warm-up run (on the card phase 4
    warms the step shapes): every check passes — one quarantined request
    under exc and under nan, one relaunch with every stream equal, the
    cap's failed engine, the deadline's cancel mid-batch, deferred
    admissions under the fitted head, the SLO watchdog's exit 0."""
    model, _ = tiny_gpt
    prompts, temps = cs.serve_prompts(model.config.vocab_size)
    assert temps == [0.0] * 8
    cs.fault_run("warm-up", model, prompts, cs.SERVE_ENGINE)
    got = cs.fault_main_path(model)
    print(capsys.readouterr().out)
    assert faulting == []
    runs = got["runs"]
    assert set(runs) == {"clean", "exc", "nan", "stall", "cap", "deadline",
                         "predicted"}
    assert runs["clean"]["k7"] == 2 * runs["clean"]["stats"]["steps"] > 0
    assert runs["stall"]["stats"]["watchdog_relaunches"] == 1
    assert got["relaunch"]["relaunch_s"] > 0
    assert got["predicted"]["prefill_s"] > got["predicted"]["budget_s"] \
        > got["predicted"]["decode_s"]
    assert got["slo"] == 0


def test_fault_phase_sees_a_stream_that_differs(faulting, tiny_gpt,
                                               capsys):
    """A stream that differs from the clean run where the margin is wide
    fails the token check."""
    model, _ = tiny_gpt
    prompts, _ = cs.serve_prompts(model.config.vocab_size)
    want = [[1, 2, 3]] * len(prompts)
    got = [list(w) for w in want]
    got[1] = [1, 9, 3]
    cs.hold_tokens("control", model, prompts, want, got)
    capsys.readouterr()
    assert any("request 1 differs" in f for f in faulting)


def test_llama_relaunch_phase_holds_on_the_cpu(faulting, capsys):
    """Phase 4g on a tiny GQA LLaMA: one relaunch, every stream equal to
    the clean run's, health degraded then ok."""
    model = tllama.LlamaForCausalLM(tllama.llama_config("tiny"),
                                    device="cpu", seed=0)
    got = cs.llama_relaunch_main_path(model)
    print(capsys.readouterr().out)
    assert faulting == []
    # the stalled step launched nothing and the re-prefill took its place
    assert got["k7"] == got["clean_k7"] > 0
    assert got["relaunch"]["pool_bytes"] > 0


def test_k1_k2_cases_hold_ernie_moe_shapes():
    """Phase 5's "ernie" cases are phase 22's attention (batch x heads,
    seq, head_dim 64, bf16, non-causal) and LayerNorm rows (batch x seq,
    width 768, fp32 under O2)."""
    cfg = cs.moe_config()
    d = cfg.hidden_size // cfg.num_heads
    assert cs.K1_CASES["ernie"] == (cs.MOE_BATCH * cfg.num_heads,
                                    cs.MOE_SEQ, cs.MOE_SEQ, 1, False,
                                    torch.bfloat16, d) == \
        (96, 512, 512, 1, False, torch.bfloat16, 64)
    assert cs.K2_CASES["ernie"] == (cs.MOE_BATCH * cs.MOE_SEQ,
                                    cfg.hidden_size, torch.float32,
                                    torch.float32, "randn")


def test_moe_counts_match_the_model():
    """``moe_param_count`` / ``moe_tensor_count`` against a model built
    on the CPU (64 experts cut to 4 layers and a small vocabulary), and
    the base model's 1672 tensors (1536 expert weights and biases)."""
    from paddle_tpu_torch.models import ErnieMoEForPretraining
    cfg = cs.moe_config()
    assert cs.moe_tensor_count(cfg, cfg.num_experts) == 1672
    small = cs.ernie_moe_config("ernie-moe-base", num_layers=4,
                                vocab_size=1000, hidden_size=64,
                                num_heads=4)
    m = ErnieMoEForPretraining(small, device="cpu")
    assert sum(p.numel() for p in m.parameters()) == \
        cs.moe_param_count(small)
    assert len(list(m.parameters())) == \
        cs.moe_tensor_count(small, small.num_experts)


@pytest.fixture
def tiny_moe(monkeypatch):
    """Phase 22 on the CPU: the tiny preset at 4 layers (MoE every 2nd
    block), batch 4 x 32, the card's memory and clocks stubbed."""
    from functools import partial
    from paddle_tpu_torch.models import ernie_moe as tem
    monkeypatch.setattr(cs, "card", lambda: torch.device("cpu"))
    monkeypatch.setattr(cs, "moe_config", lambda: tem.ernie_moe_config(
        "tiny", hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
        num_layers=4, moe_every=2))
    monkeypatch.setattr(cs, "MOE_BATCH", 4)
    monkeypatch.setattr(cs, "MOE_SEQ", 32)
    monkeypatch.setattr(cs, "ErnieMoEForPretraining",
                        partial(tem.ErnieMoEForPretraining, device="cpu"))
    for name in ("empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)


def test_moe_phase_holds_on_the_cpu(tiny_moe, failures, capsys):
    """Phase 22 at one card, on the CPU: the forms' check holds and sees
    its fault; finite, falling losses; only the launch counts fail, which
    no plain version moves."""
    m = cs.ernie_moe_main_path()
    out = capsys.readouterr().out
    print(out)
    assert failures and all("launches" in f for f in failures), failures
    assert "index form vs einsum form" in out
    assert m["forms_err"] <= 1e-5
    assert len(m["dropped"]) == 2 and m["losses"][-1] < m["losses"][0]


def test_moe_forms_check_sees_a_wrong_combine(failures, monkeypatch,
                                              capsys):
    """A combine that drops its second choice fails the forms' check."""
    from paddle_tpu_torch.incubate.distributed.models.moe import moe_layer
    monkeypatch.setattr(cs, "card", lambda: torch.device("cpu"))
    real = moe_layer.route

    def first_only(*a, **kw):
        w, e, places, keep = real(*a, **kw)
        keep = keep.clone()
        keep[:, 1:] = False
        return w, e, places, keep
    cs.check_moe_forms()
    assert failures == []
    orig_forward = moe_layer.MoELayer.forward

    def forward(self, x):
        moe_layer.route = first_only
        try:
            return orig_forward(self, x)
        finally:
            moe_layer.route = real
    monkeypatch.setattr(moe_layer.MoELayer, "forward", forward)
    cs.check_moe_forms()
    print(capsys.readouterr().out)
    assert any("from the einsum form" in f for f in failures), failures


# phase 24's chaos run starts its workers as ``chip_smoke.py
# --resilient-worker DIR``; on the CPU they are this script, which puts
# the same stand-ins in place first
_CK_WORKER = r"""
import functools, os, sys
sys.path.insert(0, {root!r})
import torch
for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
    setattr(torch.cuda, name, lambda *a, **k: None)
torch.Tensor.cuda = lambda self, *a, **k: self
import chip_smoke as cs
from paddle_tpu_torch.models import gpt as tgpt
cs.GPTForPretraining = lambda cfg, seed: tgpt.GPTForPretraining(
    cfg, device="cpu", seed=seed)
cs.gpt_config = lambda name, **kw: tgpt.gpt_config("tiny", **kw)
cs.TRAIN_BATCH, cs.TRAIN_SEQ = 2, 32
cs.ck_per_step = lambda layers, n: {{k: 0 for k in cs.PER_STEP}}
sys.exit(cs.resilient_worker(sys.argv[sys.argv.index("--resilient-worker")
                                      + 1]))
"""


class _Failed(Exception):
    pass


@pytest.fixture
def checkpointing(monkeypatch, tmp_path):
    """Phase 24 at one card on the CPU: the tiny GPT at 3 layers, no
    launches to count, the chaos run's workers on the CPU and a 4 s
    stall timeout; a failed check raises."""
    def fail(msg):
        raise _Failed(msg)
    monkeypatch.setattr(cs, "fail", fail)
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: 0)
    monkeypatch.setattr(torch.Tensor, "cuda", lambda self, *a, **k: self)
    monkeypatch.setattr(cs, "GPTForPretraining", lambda cfg, seed:
                        tgpt.GPTForPretraining(cfg, device="cpu",
                                               seed=seed))
    monkeypatch.setattr(cs, "gpt_config", lambda name, **kw:
                        tgpt.gpt_config("tiny", **kw))
    monkeypatch.setattr(cs, "TRAIN_BATCH", 2)
    monkeypatch.setattr(cs, "TRAIN_SEQ", 32)
    monkeypatch.setattr(cs, "N_LAYERS", 3)
    monkeypatch.setattr(cs, "CK_HEARTBEAT_S", 4.0)
    monkeypatch.setattr(cs, "ck_per_step",
                        lambda layers, n: {k: 0 for k in cs.PER_STEP})
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = tmp_path / "ck_worker.py"
    worker.write_text(_CK_WORKER.format(root=root))
    monkeypatch.setattr(cs, "__file__", str(worker))


def test_checkpoint_phase_holds_on_the_cpu(checkpointing, capsys):
    """Save, load into a fresh model and optimizer, step 3 bit-equal; the
    async save; both controls failing their checks; the chaos run with a
    crash and a stall, bit-equal to the uninterrupted run."""
    out = cs.checkpoint_one_card()
    print(capsys.readouterr().out)
    assert out["bit_equal"] and out["load"]["version"] == "2"
    assert out["save"]["bytes"] == out["load"]["bytes"] > 0
    assert out["async"]["committed"]
    for io in (out["save"], out["load"], out["async"]):
        assert 0 < io["part_bytes"] < io["share_bytes"]
    assert not out["control_copies"]["model_holds_loaded"]
    assert out["control_copies"]["copies_changed"] > 0
    assert out["control_missing"]["raised"] == "FileNotFoundError"
    rep = out["chaos"]["report"]
    assert rep["crashes"] == 1 and rep["stalls"] == 1 and rep["code"] == 0
    assert [r["loaded"] for r in out["chaos"]["runs"]] == [None, "0", "2"]


@pytest.mark.parametrize("split", [True, False])
def test_checkpoint_io_holds_a_call_to_its_share(checkpointing,
                                                 monkeypatch, split):
    """``ck_io`` passes a call that holds nothing and fails one that holds
    more host memory than the share and one local part, also where the
    host gives its resident bytes without the anonymous / file split."""
    monkeypatch.setattr(cs, "CK_HOST_SLACK", 16 << 20)
    if not split:
        real = cs.ck_rss
        monkeypatch.setattr(cs, "ck_rss", lambda: (real()[0], None, None))
    state = {"model": torch.nn.Linear(8, 8).state_dict()}
    io = cs.ck_io("nothing", lambda: None, state)
    assert io["share_bytes"] == 4 * (64 + 8) and io["part_bytes"] == 256
    assert (io["host_anon_added_bytes"] is None) != split
    held = []
    with pytest.raises(_Failed, match="host resident"):
        cs.ck_io("a copy", lambda: held.append(np.ones(8 << 20)), state)


def test_checkpoint_phase_fails_when_the_load_writes_nothing(
        checkpointing, monkeypatch):
    """The bit-equal check sees a load that leaves the fresh model as it
    was built."""
    from paddle_tpu_torch.distributed import checkpoint as dck
    monkeypatch.setattr(dck, "_copy_overlaps", lambda *a, **k: None)
    with pytest.raises(_Failed, match="not bit-equal"):
        cs.checkpoint_one_card()


@pytest.fixture
def engine_phase(tiny_moe, failures, monkeypatch):
    """Phase 25 at one card on the CPU: phase 22's tiny stand-ins, K3
    counted where the optimizers call it (the other kernels' plain
    versions count nothing, so their launches are held at 0)."""
    from paddle_tpu_torch.optimizer import optimizers as opts
    real = opts.fused_adamw_update_

    def counted(*a, **k):
        cs.adamw.launches += 1
        return real(*a, **k)
    monkeypatch.setattr(opts, "fused_adamw_update_", counted)

    def per_step(n_tensors):
        per = {k: 0 for k in cs.PER_STEP}
        per["adamw"] = n_tensors
        return per
    monkeypatch.setattr(cs, "moe_per_step", per_step)
    monkeypatch.setattr(cs, "CARD", "cpu")
    return failures


def test_auto_parallel_phase_holds_on_the_cpu(engine_phase, capsys):
    """Phase 25 at one card: Engine.fit bit-equal to phase 22's
    train_step (losses, parameters, masters), launches exact, cost()
    counted, evaluate / predict, and a save loaded into a fresh engine
    that steps bit-equal."""
    m = cs.auto_parallel_one_card()
    out = capsys.readouterr().out
    print(out)
    assert engine_phase == []
    assert m["bit_equal"] and m["losses"] == m["ref_losses"]
    assert m["launches"]["adamw"] == 8 * m["n_tensors"]
    assert m["cost_flops"] == m["step_flops"] and m["cost_ms"] > 0
    assert m["eval_loss"] == m["next_loss"] and m["saved_bytes"] > 0
    assert "bit-equal to train_step's" in out and "0 tensors differ" in out


def test_auto_parallel_phase_sees_an_engine_that_adds_math(engine_phase,
                                                           monkeypatch):
    """An Engine that adds a term to the loss (an L2 penalty of 1e-2)
    fails the bit-equal checks."""
    real = cs.Engine._step_fn

    def step_fn(self):
        fn = real(self)
        return lambda model, *b: fn(model, *b) + 1e-2 * sum(
            p.float().square().sum() for p in model.parameters())
    monkeypatch.setattr(cs.Engine, "_step_fn", step_fn)
    cs.auto_parallel_one_card()
    assert any("losses" in f for f in engine_phase), engine_phase
    assert any("not bit-equal to train_step's" in f for f in engine_phase)


def test_auto_parallel_kernels_line_has_every_key():
    """Phase 25's kernels line: K1a-c, K2a/b and K3, each entry and each
    path with the contract's keys, the launches its path's."""
    def k1(case):
        return dict(max_abs_err=dict(o=1e-3, dq=2e-3, dkv=3e-3),
                    library_max_abs_err={}, fwd_ms=0.05, dq_ms=0.06,
                    dkv_ms=0.07, plain_fwd_ms=0.4, plain_bwd_ms=0.7,
                    library_fwd_ms=0.02, library_bwd_ms=0.07,
                    fwd_bound=(0.01, "bytes"), dq_bound=(0.01, "operations"),
                    dkv_bound=(0.01, "operations"))

    def k2(case):
        return dict(max_abs_err=dict(y=1e-6, dx=2e-6), fwd_ms=0.006,
                    dx_ms=0.009, plain_fwd_ms=0.08, plain_dx_ms=0.15,
                    library_fwd_ms=0.013, library_dx_ms=0.012,
                    fwd_bound=(0.007, "bytes"), dx_bound=(0.011, "bytes"))
    k3 = {c: dict(max_abs_err=0.0, ms=0.02, plain_ms=0.18,
                  bound=(0.02, "bytes"), library_ms=0.04)
          for c in ("ernie", "main", "bart")}
    launched = {k: 0 for k in cs.PER_STEP}
    launched.update(flash_fwd=96, flash_bwd_dq=96, flash_bwd_dkv=96,
                    ln_fwd=200, ln_bwd_dx=200, adamw=13376)
    mp = dict(launched, flash_fwd=0, flash_bwd_dq=0, flash_bwd_dkv=0,
              ln_fwd=0, ln_bwd_dx=0, adamw=576)
    shape = dict(k1="a", k2="b", k3="c")
    paths = {"ernie_moe_engine": (launched, "ernie", "ernie", "ernie",
                                  shape),
             "mp_stack": (mp, None, None, "bart", shape)}
    kernels = cs.auto_parallel_kernels(
        {"ernie": k1("ernie")}, {"ernie": k2("ernie")}, k3, paths)
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert [k["name"] for k in kernels] == [
        "flash_attention_fwd", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv", "layer_norm_fwd", "layer_norm_bwd_dx",
        "fused_adamw"]
    for k in kernels:
        assert keys <= set(k) and k["route"] == "cuda"
        assert os.path.exists(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), k["source"]))
        for entry in k["by_path"].values():
            assert keys - {"name", "route", "source", "replaces"} <= \
                set(entry)
    assert kernels[0]["launches"] == 96 and set(kernels[0]["by_path"]) == {
        "ernie_moe_engine"}
    assert kernels[-1]["by_path"]["mp_stack"]["launches"] == 576
    assert [k["shape"] for k in kernels] == ["a"] * 3 + ["b"] * 2 + ["c"]


def test_auto_parallel_cases_are_the_ranks_shapes():
    """Phase 25's four-card paths have K1 / K2 / K3 cases at their own
    per-rank shapes: a dp 2 rank's half of ERNIE-MoE's batch, GPT-3
    1.3B's batch of 4 over each tuned layout's data ranks, and the mp
    stack's weights whole (dp 4) and halved (mp 2)."""
    cfg = cs.moe_config()
    gpt = tgpt.gpt_config("gpt3-1.3B")
    half = cs.MOE_BATCH // 2
    assert cs.K1_CASES["ernie-dp2"] == (
        half * cfg.num_heads, cs.MOE_SEQ, cs.MOE_SEQ, 1, False,
        torch.bfloat16, cfg.hidden_size // cfg.num_heads)
    assert cs.K2_CASES["ernie-dp2"] == (half * cs.MOE_SEQ, cfg.hidden_size,
                                        torch.float32, torch.float32,
                                        "randn")
    rows = {cs.ap_rows(dp, sh) for dp, sh, _ in cs.AP_TUNE}
    assert rows == {"1row", "2rows"}
    for name in rows:
        n = int(name.split("row")[0])
        assert cs.K1_CASES["gpt-" + name] == (
            n * gpt.num_heads, cs.TRAIN_SEQ, cs.TRAIN_SEQ, 1, True,
            torch.bfloat16, gpt.hidden_size // gpt.num_heads)
        assert cs.K2_CASES["gpt-" + name] == (
            n * cs.TRAIN_SEQ, gpt.hidden_size, torch.float32, torch.float32,
            "randn")
    h, f = cs.AP_MP_WIDTH
    src = open(cs.__file__).read()
    assert f'(({h}, {f}), False, "mp_full")' in src
    assert f'(({h}, {f // 2}), False, "mp_shard")' in src


class _NoDist:
    pass


@pytest.mark.parametrize("fault", [None, "error", "skipped"])
def test_auto_parallel_tune_check_holds_every_candidate(failures,
                                                        monkeypatch, fault):
    """Phase 25's tune check fails unless every candidate of ``AP_TUNE``
    ran to a step time: a candidate that raised (its ``error``) or was
    skipped fails it; a report where all ran passes."""
    monkeypatch.setattr(cs, "N_LAYERS", 2)
    monkeypatch.setattr(cs, "PER_STEP", {k: 0 for k in cs.PER_STEP})
    monkeypatch.setattr(cs, "release_groups", lambda dist: None)

    def tune(self, ids, labels, candidates=None):
        report = [dict(dp=dp, sharding=sh, mp=mp, step_s=0.1)
                  for dp, sh, mp in candidates]
        if fault is not None:
            report[-1].pop("step_s")
            report[-1][fault] = "a candidate the port cannot lay out"
        self.tuning_report = report
        return dict(dp=1, sharding=1, mp=1, report=report)
    monkeypatch.setattr(cs.Engine, "tune", tune)
    t = cs.ap_tune_rank(_NoDist(), 0, 1, torch.device("cpu"))
    if fault is None:
        assert failures == [] and t["steps"] == 2 * len(cs.AP_TUNE) + \
            cs.AP_TUNE_FIT
    else:
        assert len(failures) == 1 and "tune ran" in failures[0], failures


def test_auto_parallel_control_breaks_the_column_backward(monkeypatch):
    """The mp 2 check's control leaves out the column half's dx sum over
    the mp ranks while it is active, and only then."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel.parallel_layers \
        import mp_layers
    seen = []
    monkeypatch.setattr(mp_layers, "_all_reduce",
                        lambda x, group: seen.append(x) or x)
    real = mp_layers._ColumnLinear.backward

    def backward():
        x = torch.ones(3, 4, requires_grad=True)
        w = torch.ones(4, 2, requires_grad=True)
        (y,) = mp_layers._ColumnLinear.apply(x, None, False, w, None)
        y.sum().backward()
    with cs.ap_dx_sum_left_out():
        backward()
    assert seen == []
    backward()
    assert len(seen) == 1 and mp_layers._ColumnLinear.backward is real
