"""The port's ``decode_loop`` / ``decode_compile`` and ``graph_pass``
records against the JAX package's: the same tiny ``decode_loop`` calls
(GPT, the JAX weights carried over) and the same captured decode step
through the default pass pipeline and the verifier give records of the
same kinds, in the same order, with the same fields and the same values
apart from times, ids and op counts (each package captures its own op
trace).  The JAX package's ``compile`` records (``jax.monitoring``'s XLA
compile telemetry) have no counterpart in the port and are left out.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.analysis import pass_check as jax_pass_check
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.flags import set_flags as jax_set_flags
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.models.gpt import gpt_config as jax_gpt_config
from paddle_tpu.observability import events as jax_events
from paddle_tpu.static import passes as jax_passes

from paddle_tpu_torch.analysis import pass_check
from paddle_tpu_torch.flags import set_flags
from paddle_tpu_torch.models import (GPTForPretraining, gpt_config,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.observability import events
from paddle_tpu_torch.static.passes import (capture_decode_program,
                                            run_program_passes)

_NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
IDS = np.array([[3, 9, 17, 25], [4, 8, 15, 16]], np.int64)
# fields that differ from run to run (times, ids) or by package (op
# counts of each package's own capture)
VOLATILE = {"ts", "pid", "run", "span", "parent", "trace_id", "dur_s",
            "start_ts", "ops_before", "ops_after", "removed", "hints",
            "op_class_delta"}


@pytest.fixture(scope="module")
def models():
    paddle.seed(3)
    jm = JaxGPT(jax_gpt_config("tiny", **_NO_DROPOUT))
    jm.eval()
    pm = GPTForPretraining(gpt_config("tiny", **_NO_DROPOUT), device="cpu")
    load_paddle_tpu_state(pm, {k: np.asarray(v._data)
                               for k, v in jm.state_dict().items()})
    return jm, pm


@pytest.fixture
def logs(tmp_path):
    """An event directory for each package."""
    dirs = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    jax_set_flags({"FLAGS_observability_dir": dirs["jax"]})
    set_flags({"FLAGS_observability_dir": dirs["port"]})
    try:
        yield dirs
    finally:
        jax_set_flags({"FLAGS_observability_dir": ""})
        set_flags({"FLAGS_observability_dir": ""})


def _shape(rec):
    """A record without its volatile fields; a span's attrs likewise."""
    out = {k: v for k, v in rec.items() if k not in VOLATILE}
    if isinstance(out.get("attrs"), dict):
        out["attrs"] = {k: v for k, v in out["attrs"].items()
                        if k not in VOLATILE}
    out["fields"] = sorted(rec)
    return out


def _records(logs):
    jax_recs = [r for r in jax_events.read_events(logs["jax"])
                if r["kind"] != "compile"]
    return jax_recs, events.read_events(logs["port"])


def test_decode_loop_records_match_jax(models, logs):
    jm, pm = models
    for _ in range(2):           # the second call has no decode_compile
        jm.generate(Tensor(IDS), max_new_tokens=6, _megakernel=True)
        tgen.decode_loop(pm, IDS, max_new_tokens=6)
    # a request the compiled loop does not take: the fallback event
    jm.generate(Tensor(IDS), max_new_tokens=6, _megakernel=True,
                use_cache=False)
    tgen.decode_loop(pm, IDS, max_new_tokens=6, use_cache=False)
    jax_recs, recs = _records(logs)
    assert [_shape(r) for r in recs] == [_shape(r) for r in jax_recs]
    names = [r.get("name") or r["kind"] for r in recs]
    assert names == ["decode_compile", "decode_loop", "decode_loop",
                     "decode_loop", "decode_loop", "decode_loop"]
    # the compile span is a child of the call's decode_loop span, and the
    # event lands inside it
    spans = {r["span"]: r for r in recs if r["kind"] == "trace_span"}
    assert spans[recs[0]["parent"]]["name"] == "decode_loop"
    assert recs[1]["span"] == recs[0]["parent"]
    assert recs[-1]["fallback"] == "no_kv_cache"


def test_graph_pass_records_match_jax(models, logs):
    jm, pm = models
    jprog, _, jfetches, _ = jax_passes.capture_decode_program(
        jm, Tensor(IDS))
    jax_passes.run_program_passes(jprog, jfetches, label="decode")
    prog, _, fetches, _ = capture_decode_program(pm, IDS)
    run_program_passes(prog, fetches, label="decode")
    # the verifier: one pass, then the registered passes and the pipeline
    assert jax_pass_check.verify_pass(
        "program_cse", jax_pass_check.build_corpus(n=1),
        check_hazards=False) == []
    assert pass_check.verify_pass(
        "program_cse", pass_check.build_corpus(n=1),
        check_hazards=False) == []
    assert jax_pass_check.verify_registered_passes(
        jax_pass_check.build_corpus(n=1), check_hazards=False) == []
    assert pass_check.verify_registered_passes(
        pass_check.build_corpus(n=1), check_hazards=False) == []
    jax_recs, recs = _records(logs)
    assert {r["kind"] for r in recs} == {"graph_pass"}
    assert [_shape(r) for r in recs] == [_shape(r) for r in jax_recs]
    decode = [r for r in recs if r["program"] == "decode"]
    jdecode = [r for r in jax_recs if r["program"] == "decode"]
    assert [r["pass_name"] for r in decode] == \
        list(jax_passes.DEFAULT_PIPELINE)
    # the kernel claim takes the same chains in both packages, and the
    # hint passes find as many hints
    claim = [(r["removed"], j["removed"]) for r, j in zip(decode, jdecode)
             if r["pass_name"] == "program_claim_fused_kernels"]
    assert claim == [(5, 5)]
    assert [r["hints"] for r in decode] == [r["hints"] for r in jdecode]
    assert any(r["pass_name"] == "pipeline" and r["allclose"]
               for r in recs)
