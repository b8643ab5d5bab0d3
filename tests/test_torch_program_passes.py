"""The port's program capture (``static.capture``), pass pipeline
(``static.passes``) and replay-equivalence verifier
(``analysis.pass_check``), mirroring ``tests/test_program_passes.py``:

* the capture's recording rules (named ops record one op each, raw
  tensor ops under the JAX names, non-tensor arguments kept; identity
  calls, calls returning no tensor and in-place ops handled so that the
  passes stay sound);
* per-pass semantics (CSE with different non-tensor arguments, folding
  against feeds, parameters and buffers, DCE roots, fusion barriers,
  remat and donation hints, the remat/recompute conflict);
* the randomized-corpus property and planted faults the verifier must
  flag;
* the kernel claim's refusals;
* the tiny GPT and LLaMA decode steps of ``tests/test_program_passes.py``
  with the JAX package's weights carried over: both captures SSA, the
  claimed chains equal the JAX package's in order, the op counts of the
  matmul, norm, attention and embedding classes equal JAX's, and the
  optimized replay's logits and caches within 1e-5 of the JAX program's
  replay and of the port's unoptimized replay (fp32 on both sides, the
  same products summed in other orders by XLA and torch); the default
  pipeline removes at least 10 % of the records (the JAX bar).

The CPU runs every op's plain version; the claimed records replay
through ``ops.fused_decode.norm_matmul``'s plain version.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.analysis import pass_check as jax_pass_check
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.static import passes as jax_passes

from paddle_tpu_torch.analysis import pass_check
from paddle_tpu_torch.distributed.passes import (PASS_REGISTRY, PassContext,
                                                 PassManager, new_pass,
                                                 register_pass)
from paddle_tpu_torch.incubate.nn.functional import fused_rms_norm
from paddle_tpu_torch.models import (GPTConfig, GPTForPretraining,
                                     LlamaConfig, LlamaForCausalLM,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.static import Program, capture_ops
from paddle_tpu_torch.static.passes import (DEFAULT_PIPELINE,
                                            PROGRAM_PASSES,
                                            ProgramPassBase,
                                            capture_decode_program, graph,
                                            pipeline_names,
                                            run_program_passes)

DECODE_TOL = 1e-5


def _capture(build, seed=0):
    """Capture build(x, y) into a fresh program; returns (program,
    feed_names, fetches)."""
    rs = np.random.RandomState(seed)
    prog = Program()
    x = torch.from_numpy(rs.randn(4, 4).astype("float32"))
    y = torch.from_numpy(rs.randn(4, 4).astype("float32"))
    prog.add_placeholder("x", x)
    prog.add_placeholder("y", y)
    with torch.no_grad(), capture_ops(prog):
        fetches = build(x, y)
    return prog, ["x", "y"], list(fetches)


def _fresh_feeds(seed=7):
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(rs.randn(4, 4).astype("float32"))
            for _ in range(2)]


def _assert_equiv(prog, opt, feed_names, fetches):
    res = pass_check.check_equivalence(prog, opt, feed_names, fetches,
                                       _fresh_feeds())
    assert res["allclose"], res
    return res


def _names(prog):
    return [graph.op_display_name(op) for op in prog.ops]


# ---------------------------------------------------------------------------
# the capture's recording rules
# ---------------------------------------------------------------------------

def test_named_ops_record_once_with_their_arguments():
    w = torch.nn.Parameter(torch.randn(4, 4))
    nw, nb = torch.ones(4), torch.zeros(4)

    def build(x, y):
        h = F.layer_norm(x, 4, nw, nb, 1e-5)
        return [F.matmul(h, w, transpose_y=True), F.linear(h, w)]
    prog, _, _ = _capture(build)
    assert _names(prog) == ["layer_norm", "matmul", "linear"]
    ln, mm, lin = prog.ops
    assert ln.kwargs["epsilon"] == 1e-5 and ln.kwargs["normalized_shape"] == 4
    assert [t is u for t, u in zip(ln.inputs, (prog.placeholders["x"], nw,
                                               nb))] == [True] * 3
    assert mm.kwargs["transpose_y"] is True and \
        mm.kwargs["transpose_x"] is False
    assert lin.kwargs["bias"] is None and len(lin.inputs) == 2


def test_rms_norm_records_one_single_output_op():
    w = torch.nn.Parameter(torch.ones(4))

    def build(x, y):
        out, none = fused_rms_norm(x, w, epsilon=1e-6)
        assert none is None
        return [out]
    prog, _, _ = _capture(build)
    assert _names(prog) == ["rms_norm"]
    (op,) = prog.ops
    assert not op.multi_out and len(op.outputs) == 1 and len(op.inputs) == 2
    assert op.kwargs["epsilon"] == 1e-6


def test_raw_ops_take_the_jax_names_and_keep_their_arguments():
    def build(x, y):
        a = (x + y).reshape(2, 8)
        b = torch.cat([a, a * 2.0], dim=0)
        return [b[1:3], torch.arange(4) - 1]
    prog, _, _ = _capture(build)
    assert _names(prog) == ["add", "reshape", "multiply", "concat",
                            "getitem", "arange", "subtract"]
    assert prog.ops[1].kwargs["args"][1:] == (2, 8)
    assert prog.ops[4].kwargs["args"][1] == slice(1, 3)
    assert prog.ops[3].kwargs["kwargs"] == {"dim": 0}


def test_identity_calls_and_calls_without_tensors_are_not_recorded():
    def build(x, y):
        assert x.shape == (4, 4) and x.dim() == 2
        a = F.dropout(x, 0.5, training=False)      # returns x itself
        b = a.contiguous().to(torch.float32)       # x itself twice
        assert b is x
        return [torch.tanh(b)]
    prog, _, _ = _capture(build)
    assert _names(prog) == ["tanh"]
    assert prog.ops[0].inputs[0] is prog.placeholders["x"]


def test_in_place_ops_break_ssa_and_every_pass_bails():
    def build(x, y):
        a = x + y
        a.mul_(2.0)
        b = x + y
        return [torch.tanh(a) + b]
    prog, feeds, fetches = _capture(build)
    assert "mul_" in _names(prog)
    assert not graph.is_ssa(prog.ops)
    opt, rep = run_program_passes(prog, fetches)
    assert rep["ops_after"] == rep["ops_before"]      # nothing rewritten
    assert _names(opt) == _names(prog)


def test_replay_is_a_function_of_feeds_and_externals():
    w = torch.nn.Parameter(torch.randn(4, 4))

    def build(x, y):
        return [F.matmul(x + y, w)]
    prog, feeds, fetches = _capture(build)
    pure, ext = prog.build_replay(feeds, fetches)
    assert any(t is w for t in ext)
    fx, fy = _fresh_feeds()
    (got,) = pure((fx, fy), tuple(ext))
    torch.testing.assert_close(got, (fx + fy) @ w, rtol=0, atol=0)
    # a parameter update is seen without a new capture
    with torch.no_grad():
        w.mul_(2.0)
    (got2,) = pure((fx, fy), tuple(ext))
    torch.testing.assert_close(got2, (fx + fy) @ w, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# per-pass semantics
# ---------------------------------------------------------------------------

def test_cse_merges_duplicates_and_rewires():
    def build(x, y):
        a = x + y
        b = x + y                     # identical computation
        return [F.matmul(a, b)]
    prog, feeds, fetches = _capture(build)
    opt, rep = run_program_passes(prog, fetches, names=["program_cse"])
    assert rep["ops_after"] == rep["ops_before"] - 1
    _assert_equiv(prog, opt, feeds, fetches)
    # the original program is untouched (passes work on a copy)
    assert len(prog.ops) == rep["ops_before"]


@pytest.mark.parametrize("pair", [
    (lambda x: x * 2.0, lambda x: x * 3.0),
    (lambda x: x[0], lambda x: x[1]),
    (lambda x: x[:, 1:], lambda x: x[:, :3]),
    (lambda x: x.reshape(2, 8), lambda x: x.reshape(8, 2)),
    (lambda x: F.matmul(x, x), lambda x: F.matmul(x, x, transpose_y=True)),
    (lambda x: F.gelu(x), lambda x: F.gelu(x, approximate=True)),
], ids=["scale", "index", "slice", "shape", "transpose_y", "approximate"])
def test_cse_distinguishes_non_tensor_arguments(pair):
    """Same op, same inputs, different non-tensor arguments: the records
    must NOT merge (the port's form of the closure-value soundness
    rule)."""
    f, g = pair

    def build(x, y):
        return [f(x).sum() + g(x).sum()]
    prog, feeds, fetches = _capture(build)
    opt, rep = run_program_passes(prog, fetches, names=["program_cse"])
    assert rep["ops_after"] == rep["ops_before"]
    _assert_equiv(prog, opt, feeds, fetches)


def test_constant_fold_drops_const_chain_keeps_feeds_live():
    const = torch.full((4, 4), 2.0)

    def build(x, y):
        k = const * 0.5               # const chain
        k2 = k + const
        live = x + y                  # feed-dependent: NOT const
        return [live + k2]
    prog, feeds, fetches = _capture(build)
    opt, rep = run_program_passes(prog, fetches,
                                  names=["program_constant_fold"])
    assert rep["ops_after"] == rep["ops_before"] - 2
    # equivalence on FRESH feed values proves nothing feed-dependent
    # was frozen at its capture-time value
    _assert_equiv(prog, opt, feeds, fetches)


class _Scaled(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("scale", torch.full((4, 4), 3.0),
                             persistent=False)

    def forward(self, x):
        return x + self.scale * 2.0


@pytest.mark.parametrize("kind", ["parameter", "buffer"])
def test_constant_fold_never_folds_parameters_or_buffers(kind):
    w = torch.nn.Parameter(torch.randn(4, 4))
    mod = _Scaled()

    def build(x, y):
        if kind == "parameter":
            return [x + w * 2.0]      # param-derived: not const
        return [mod(x)]               # buffer-derived: not const
    prog, feeds, fetches = _capture(build)
    if kind == "buffer":
        assert id(mod.scale) in prog.buffers
    opt, rep = run_program_passes(prog, fetches,
                                  names=["program_constant_fold"])
    assert rep["ops_after"] == rep["ops_before"]
    with torch.no_grad():             # an update between runs is seen
        (w if kind == "parameter" else mod.scale).add_(1.0)
    _assert_equiv(prog, opt, feeds, fetches)
    (got,) = pass_check.replay_outputs(opt, feeds, fetches, _fresh_feeds())
    fx = _fresh_feeds()[0]
    want = fx + w * 2.0 if kind == "parameter" else fx + mod.scale * 2.0
    torch.testing.assert_close(got, want.detach(), rtol=0, atol=0)


def test_dce_drops_dead_branch_keeps_writeback_sources():
    w = torch.nn.Parameter(torch.randn(4, 4))

    def build(x, y):
        live = torch.tanh(F.matmul(x, y))
        dead = x * y
        torch.tanh(dead)              # dead chain
        build.new_w = w - live * 0.1
        return [live]
    prog, feeds, fetches = _capture(build)
    prog.writebacks.append((w, build.new_w))
    opt, rep = run_program_passes(prog, fetches, names=["program_dce"])
    assert rep["ops_after"] == rep["ops_before"] - 2
    # the update tail feeding the writeback source survived
    assert "subtract" in _names(opt)
    _assert_equiv(prog, opt, feeds, fetches)


def test_fuse_composes_chains_and_respects_sharing():
    def build(x, y):
        a = F.matmul(x, y)            # single consumer -> fusable
        b = torch.tanh(a)
        shared = b + y                # two consumers -> barrier
        c = shared * 0.5
        d = torch.abs(shared)
        return [c + d]
    prog, feeds, fetches = _capture(build)
    opt, rep = run_program_passes(prog, fetches, names=["program_fuse"])
    assert rep["ops_after"] < rep["ops_before"]
    assert any("matmul+tanh" in n for n in _names(opt))
    _assert_equiv(prog, opt, feeds, fetches)


def test_fusion_hints_flag_norm_matmul_chains():
    prog = Program()
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 8, 16)
                         .astype("float32"))
    prog.add_placeholder("x", x)
    nw, nb = torch.nn.Parameter(torch.ones(16)), \
        torch.nn.Parameter(torch.zeros(16))
    w, b = torch.nn.Parameter(torch.randn(16, 16)), \
        torch.nn.Parameter(torch.zeros(16))
    with torch.no_grad(), capture_ops(prog):
        out = F.linear(F.layer_norm(x, 16, nw, nb), w, b)
    opt, rep = run_program_passes(prog, [out], names=["program_fuse"])
    assert {h["kind"] for h in opt.fusion_hints} == {"norm_matmul"}
    assert all(h["claimable_by"] == "ops.fused_decode"
               for h in opt.fusion_hints)


def test_remat_and_donation_hints():
    w = torch.nn.Parameter(torch.randn(4, 4))

    def build(x, y):
        cheap = x + y                 # cheap, multi-consumer
        u = F.matmul(cheap, w)
        v = F.matmul(w, cheap)
        build.new_w = w - u * 0.01
        return [u, v]
    prog, feeds, fetches = _capture(build)
    prog.writebacks.append((w, build.new_w))
    prog.name_var(w, "w_hint")
    opt, _ = run_program_passes(prog, fetches,
                                names=["program_remat_hints"])
    assert any(h["kind"] == "remat" and h["consumers"] >= 2
               for h in opt.remat_hints)
    assert any(h["kind"] == "donate" and h["external"] == "w_hint"
               for h in opt.donation_hints)


def test_remat_pass_conflicts_with_recompute_pass():
    """PassManager incompatibility does real work across families."""
    prog, _, fetches = _capture(lambda x, y: [x + y])
    manager = PassManager([new_pass("auto_parallel_recompute"),
                           new_pass("program_remat_hints")])
    with pytest.raises(ValueError, match="conflicts"):
        manager.apply(prog, None, PassContext())


def test_pipeline_names_parsing():
    assert pipeline_names("") == ()
    assert pipeline_names("1") == DEFAULT_PIPELINE
    assert pipeline_names("default") == DEFAULT_PIPELINE
    assert pipeline_names("program_dce, program_cse") == \
        ("program_dce", "program_cse")
    with pytest.raises(ValueError, match="unknown pass"):
        pipeline_names("program_nope")
    assert list(DEFAULT_PIPELINE) == PROGRAM_PASSES[:len(DEFAULT_PIPELINE)]


def test_list_vars_clone_and_parameters():
    w = torch.nn.Parameter(torch.randn(4, 4))

    def build(x, y):
        z = x * 2.0
        build.z = z
        out = F.matmul(z, w)
        build.new_w = w - out * 0.1   # the training tail: consumes out
        return [out.sum()]
    prog, feeds, fetches = _capture(build)
    prog.writebacks.append((w, build.new_w))
    prog.name_var(build.z, "lv_z")
    assert any(t is build.z for t in prog.list_vars())
    assert len(prog.list_vars()) == len({id(t) for t in prog.list_vars()})
    assert prog.find_var_by_name("lv_z") is build.z
    assert prog.find_var_by_name("x") is prog.placeholders["x"]
    assert prog.all_parameters() == [w]
    # a test clone drops the write-backs and the update tail
    test_prog = prog.clone(for_test=True)
    assert test_prog.writebacks == [] and len(test_prog.ops) < len(prog.ops)
    _assert_equiv(prog, test_prog, feeds, fetches)
    train_prog = prog.clone()
    assert len(train_prog.ops) == len(prog.ops)
    assert len(train_prog.writebacks) == 1


# ---------------------------------------------------------------------------
# verification harness
# ---------------------------------------------------------------------------

def test_registered_passes_verify_clean():
    assert pass_check.verify_registered_passes() == []


def test_pipeline_property_on_randomized_corpus():
    for entry in pass_check.build_corpus(n=3, seed=11):
        prog = entry["program"]
        opt, rep = run_program_passes(prog, entry["fetches"],
                                      names=DEFAULT_PIPELINE)
        res = pass_check.check_equivalence(
            prog, opt, entry["feed_names"], entry["fetches"],
            entry["feed_arrays"])
        assert res["allclose"], (entry["label"], res)
        assert res["ops_after"] < res["ops_before"]


def _planted(name, rewrite):
    @register_pass(name)
    class _Planted(ProgramPassBase):
        def _apply_single_impl(self, main_program, startup, context):
            before = list(main_program.ops)
            main_program.ops = rewrite(before)
            self._record_stats(context, main_program, before,
                               len(before) - len(main_program.ops))
    PROGRAM_PASSES.append(name)


def _unplant(name):
    PROGRAM_PASSES.remove(name)
    PASS_REGISTRY.pop(name, None)


def test_verifier_catches_a_broken_pass():
    """A pass that drops a LIVE op must fail verification — the
    verifier's reason to exist."""
    # drop the FIRST op: a fetched value's ancestor, so the replay falls
    # back to its stale capture-time value
    _planted("program_break_everything", lambda ops: ops[1:])
    try:
        findings = pass_check.verify_pass("program_break_everything",
                                          pass_check.build_corpus(1, 3))
        assert findings and all(f.code == "PTL601" for f in findings)
    finally:
        _unplant("program_break_everything")


def test_verifier_catches_a_float64_rewrite():
    """A rewrite that keeps the values but computes in float64 is flagged
    by the float64 re-scan."""
    from paddle_tpu_torch.static.capture import _OpRecord

    def widen(ops):
        out = []
        for op in ops:
            if op.name == "add":
                def fn(a, b, _f=op.fn, _k=op.kwargs):
                    return (a.double() + b.double()).float()
                op = _OpRecord(fn, {}, op.inputs, op.outputs, op.multi_out,
                               "add")
            out.append(op)
        return out
    _planted("program_widen", widen)
    try:
        findings = pass_check.verify_pass("program_widen",
                                          pass_check.build_corpus(1, 5))
        assert findings and "float64" in findings[0].message
    finally:
        _unplant("program_widen")


def test_verifier_flags_unharnessed_registration():
    @register_pass("program_sneaky_noop")
    class _Sneaky(ProgramPassBase):
        def _apply_single_impl(self, main_program, startup, context):
            pass

    try:
        findings = pass_check.verify_registered_passes(
            pass_check.build_corpus(1, 4), check_hazards=False)
        assert any("program_sneaky_noop" in f.message and
                   f.code == "PTL601" for f in findings)
    finally:
        PASS_REGISTRY.pop("program_sneaky_noop", None)


# ---------------------------------------------------------------------------
# the kernel claim
# ---------------------------------------------------------------------------

def test_claim_refuses_multi_consumer_and_root_chains():
    """A norm output consumed twice (or fetched) must NOT be claimed —
    the rewrite would drop a live producer."""
    x = torch.from_numpy(np.random.RandomState(3).randn(4, 8)
                         .astype("float32"))
    w = torch.nn.Parameter(torch.randn(8))
    mm_w = torch.nn.Parameter(torch.randn(8, 8))
    prog = Program()
    prog.add_placeholder("cx", x)
    with torch.no_grad(), capture_ops(prog):
        n, _ = fused_rms_norm(x, w, epsilon=1e-6)
        a = F.matmul(n, mm_w)
        b = n + n                     # second consumer of the norm
        out = a + b
    ops, claimed = graph.run_claim_fused_kernels(prog.ops, {id(out)})
    assert claimed == [] and len(ops) == len(prog.ops)
    # a fetched norm output is a root: not claimed either
    prog_r = Program()
    prog_r.add_placeholder("cx", x)
    with torch.no_grad(), capture_ops(prog_r):
        n_r, _ = fused_rms_norm(x, w, epsilon=1e-6)
        out_r = F.matmul(n_r, mm_w)
    _, claimed_r = graph.run_claim_fused_kernels(prog_r.ops,
                                                 {id(out_r), id(n_r)})
    assert claimed_r == []
    # the single-consumer chain DOES claim, and replays through K6d's
    # wrapper with the norm's epsilon
    ops2, claimed2 = graph.run_claim_fused_kernels(prog_r.ops, {id(out_r)})
    assert len(claimed2) == 1 and claimed2[0]["kind"] == "norm_matmul"
    assert claimed2[0]["claimed_by"] == "ops.fused_decode.norm_matmul"
    assert len(ops2) == len(prog_r.ops) - 1
    (rec,) = ops2
    assert rec.fn is graph.claimed_norm_matmul
    assert rec.kwargs["epsilon"] == 1e-6 and rec.kwargs["kind"] == "rms_norm"


def test_claim_refuses_what_the_records_do_not_support():
    """A norm over more than the last axis, a transpose_x matmul and a
    claim that does not reproduce the captured value are refused."""
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 4, 8)
                         .astype("float32"))
    nw, nb = torch.ones(4, 8), torch.zeros(4, 8)
    w = torch.nn.Parameter(torch.randn(8, 8))
    prog = Program()
    prog.add_placeholder("x", x)
    with torch.no_grad(), capture_ops(prog):
        out = F.linear(F.layer_norm(x, [4, 8], nw, nb), w)
    _, claimed = graph.run_claim_fused_kernels(prog.ops, {id(out)})
    assert claimed == []
    prog2 = Program()
    sq = x[0, :, :4].contiguous()
    prog2.add_placeholder("x", sq)
    with torch.no_grad(), capture_ops(prog2):
        out2 = F.matmul(F.layer_norm(sq, 4, torch.ones(4), torch.zeros(4)),
                        torch.randn(4, 4), transpose_x=True)
    _, claimed2 = graph.run_claim_fused_kernels(prog2.ops, {id(out2)})
    assert claimed2 == []
    # a captured value the claimed kernel does not reproduce: the claim is
    # checked against it and refused
    prog3 = Program()
    prog3.add_placeholder("x", sq)
    with torch.no_grad(), capture_ops(prog3):
        out3 = F.linear(F.layer_norm(sq, 4, torch.ones(4), torch.zeros(4)),
                        torch.randn(4, 4))
    with torch.no_grad():
        out3.add_(1.0)
    _, claimed3 = graph.run_claim_fused_kernels(prog3.ops, {id(out3)})
    assert claimed3 == []


def _rms_matmul_program(norm_dtype):
    x = torch.from_numpy(np.random.RandomState(5).randn(4, 8)
                         .astype("float32"))
    prog = Program()
    prog.add_placeholder("x", x)
    with torch.no_grad(), capture_ops(prog):
        n, _ = fused_rms_norm(x, torch.ones(8, dtype=norm_dtype),
                              epsilon=1e-6)
        out = F.matmul(n, torch.randn(8, 8))
    return prog, out


def test_claim_refuses_mixed_dtypes():
    """K6d takes x, the norm's and the matmul's weights in one dtype: a
    bf16 norm weight over fp32 rows is left to the composition."""
    prog, out = _rms_matmul_program(torch.bfloat16)
    _, claimed = graph.run_claim_fused_kernels(prog.ops, {id(out)})
    assert claimed == []
    prog, out = _rms_matmul_program(torch.float32)
    _, claimed = graph.run_claim_fused_kernels(prog.ops, {id(out)})
    assert len(claimed) == 1


def test_claim_lets_a_kernel_error_through(monkeypatch):
    """A kernel that fails to build or launch raises out of the claim
    pass; it is never read as a refused claim (which would replay the
    unclaimed composition without a word)."""
    prog, out = _rms_matmul_program(torch.float32)

    def broken(*args, **kwargs):
        raise RuntimeError("fd_norm_matmul: launch failed")

    monkeypatch.setattr(graph._fd, "norm_matmul", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        graph.run_claim_fused_kernels(prog.ops, {id(out)})


# ---------------------------------------------------------------------------
# golden: the tiny GPT and LLaMA decode steps against the JAX package's
# ---------------------------------------------------------------------------

_GPT = dict(num_layers=2, hidden_size=64, num_heads=4, vocab_size=128,
            max_position_embeddings=64, hidden_dropout_prob=0.0,
            attention_dropout_prob=0.0)
_LLAMA = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
              num_kv_heads=2, intermediate_size=64,
              max_position_embeddings=64)
COMPARED_CLASSES = ("matmul", "norm", "attention", "embedding")


def _decode_case(name):
    if name == "gpt":
        paddle.seed(0)
        jm = JaxGPT(JaxGPTConfig(**_GPT))
        pm = GPTForPretraining(GPTConfig(**_GPT), device="cpu")
        ids = np.random.RandomState(0).randint(0, 128, (2, 6))
    else:
        paddle.seed(1)
        jm = JaxLlama(JaxLlamaConfig(**_LLAMA))
        pm = LlamaForCausalLM(LlamaConfig(**_LLAMA), device="cpu")
        ids = np.array([[3, 9, 17, 25]])
    jm.eval()
    load_paddle_tpu_state(pm, {k: np.asarray(v._data)
                               for k, v in jm.state_dict().items()})
    ids = ids.astype("int64")
    jprog, jfeeds, jfetches, jtok = jax_passes.capture_decode_program(
        jm, Tensor(ids))
    jopt, jrep = jax_passes.run_program_passes(jprog, jfetches,
                                               label=f"jax_{name}")
    prog, feeds, fetches, tok = capture_decode_program(
        pm, torch.from_numpy(ids))
    opt, rep = run_program_passes(prog, fetches, label=f"torch_{name}")
    # replays on a fresh token (the same for both packages)
    fresh = np.random.RandomState(5).randint(
        0, ids.max() + 1, (ids.shape[0], 1)).astype("int64")
    want = [np.asarray(a) for a in jax_pass_check.replay_outputs(
        jopt, jfeeds, jfetches, [fresh])]
    got = pass_check.replay_outputs(opt, feeds, fetches,
                                    [torch.from_numpy(fresh)])
    plain = pass_check.replay_outputs(prog, feeds, fetches,
                                      [torch.from_numpy(fresh)])
    return dict(jprog=jprog, jopt=jopt, jrep=jrep, jtok=np.asarray(jtok),
                prog=prog, opt=opt, rep=rep, tok=tok, feeds=feeds,
                fetches=fetches, want=want, got=got, plain=plain)


@pytest.fixture(scope="module")
def decode():
    return {name: _decode_case(name) for name in ("gpt", "llama")}


MODELS = ["gpt", "llama"]


@pytest.mark.parametrize("name", MODELS)
def test_decode_capture_is_ssa_and_takes_jax_token(decode, name):
    d = decode[name]
    assert graph.is_ssa(d["prog"].ops)
    assert graph.is_ssa(d["opt"].ops)
    np.testing.assert_array_equal(d["tok"].numpy(), d["jtok"])


@pytest.mark.parametrize("name", MODELS)
def test_decode_claimed_chains_equal_jax(decode, name):
    d = decode[name]
    want = [h["chain"] for h in d["jopt"].fusion_hints if h.get("claimed")]
    got = [h["chain"] for h in d["opt"].fusion_hints if h.get("claimed")]
    assert got == want
    assert len(got) == {"gpt": 5, "llama": 1}[name]
    assert all(h["claimed_by"] == "ops.fused_decode.norm_matmul"
               for h in d["opt"].fusion_hints if h.get("claimed"))


@pytest.mark.parametrize("name", MODELS)
def test_decode_op_classes_equal_jax(decode, name):
    d = decode[name]
    jh = jax_passes.op_class_histogram(d["jprog"].ops)
    th = graph.op_class_histogram(d["prog"].ops)
    print(f"{name}: jax {jh}\n{name}: torch {th}")
    for cls in COMPARED_CLASSES:
        assert th.get(cls, 0) == jh.get(cls, 0), (cls, th, jh)


@pytest.mark.parametrize("name", MODELS)
def test_decode_optimized_replay_matches_jax_and_unoptimized(decode, name):
    d = decode[name]
    assert len(d["got"]) == len(d["want"]) == len(d["plain"])
    assert len(d["got"]) == 1 + 2 * 2          # logits + 2 layers' (k, v)
    for i, (g, w, p) in enumerate(zip(d["got"], d["want"], d["plain"])):
        np.testing.assert_allclose(g.numpy(), w, rtol=DECODE_TOL,
                                   atol=DECODE_TOL,
                                   err_msg=f"fetch {i} vs JAX")
        np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=DECODE_TOL,
                                   atol=DECODE_TOL,
                                   err_msg=f"fetch {i} vs unoptimized")


@pytest.mark.parametrize("name", MODELS)
def test_decode_default_pipeline_reduction(decode, name):
    d = decode[name]
    rep = d["rep"]
    assert rep["reduction_pct"] >= 10.0, rep
    assert [p["pass"] for p in rep["passes"]] == list(DEFAULT_PIPELINE)
    assert [p["pass"] for p in d["opt"].pass_log] == list(DEFAULT_PIPELINE)
    claim = rep["passes"][DEFAULT_PIPELINE.index(
        "program_claim_fused_kernels")]
    assert claim["removed"] == {"gpt": 5, "llama": 1}[name]
    fuse = rep["passes"][DEFAULT_PIPELINE.index("program_fuse")]
    assert fuse["ops_before"] - fuse["ops_after"] == fuse["removed"] > 0
    res = pass_check.check_equivalence(d["prog"], d["opt"], d["feeds"],
                                       d["fetches"], [d["tok"]])
    assert res["allclose"], res
