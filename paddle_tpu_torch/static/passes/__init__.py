"""Program-level optimization pass pipeline; counterpart of
``paddle_tpu/static/passes/__init__.py`` (ref: python/paddle/distributed/
passes/ + the PIR pass ecosystem: constant_folding_pass,
dead_code_elimination_pass, the fusion pass zoo).

A captured ``Program`` (static/capture.py) is an op trace replayed as a
function of its feeds, so a pass is a functional rewrite of the op list
(graph.py), registered through the same ``PassBase``/``register_pass``/
``PassManager`` machinery as the distributed passes
(distributed/passes/pass_base.py).  Every pass is verified by replay
equivalence on a randomized corpus (``analysis.pass_check``).

* :func:`run_program_passes` — apply a pipeline to a copy of a program;
  returns ``(optimized, report)``.  The per-pass stats (op counts, op
  class deltas) land in ``program.pass_log``, the report and one
  ``graph_pass`` event a pass (the learned perf model's ``step``
  features read them);
* :func:`capture_decode_program` — capture one KV-cache decode step of a
  model as a Program (``python -m paddle_tpu_torch.static.passes`` and
  the tests use it).

The kernel-claim pass rewrites norm->matmul chains onto
``ops.fused_decode.norm_matmul``, which launches the hand-written CUDA
K6d on the card.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Set, Tuple

import torch

from ...distributed.passes.pass_base import (PassBase, PassContext,
                                             PassManager, new_pass,
                                             register_pass)
from ..capture import Program, capture_ops
from . import graph
from .graph import (collect_donation_hints, collect_fusion_hints,
                    collect_remat_hints, default_root_ids, op_class,
                    op_class_delta, op_class_histogram,
                    run_claim_fused_kernels, run_cse,
                    run_constant_fold, run_dce, run_fuse)

__all__ = [
    "PROGRAM_PASSES", "DEFAULT_PIPELINE", "pipeline_names",
    "run_program_passes", "capture_decode_program", "default_root_ids",
    "op_class", "op_class_histogram", "op_class_delta", "graph",
    "ProgramPassBase",
]

# registration order == default pipeline order: CSE first exposes
# constants (merged duplicates), folding shrinks what DCE walks, kernel
# claiming rewrites flagged chains onto the fused kernel BEFORE the
# generic fuser composes them away, hints annotate the final shape
DEFAULT_PIPELINE = ("program_cse", "program_constant_fold", "program_dce",
                    "program_claim_fused_kernels", "program_fuse",
                    "program_remat_hints")

# every program-level pass name (the verifier iterates this)
PROGRAM_PASSES = []


def _program_pass(name: str):
    def deco(cls):
        PROGRAM_PASSES.append(name)
        return register_pass(name)(cls)
    return deco


class ProgramPassBase(PassBase):
    """Shared scaffolding: resolve liveness roots, rebind program.ops
    (never mutating an _OpRecord), record stats into the context and the
    program's ``pass_log``."""

    def _roots(self, program, context: PassContext) -> Set[int]:
        roots = None
        if context is not None:
            roots = context.attrs.get("program_roots")
        if roots is None:
            roots = default_root_ids(program)
        return set(roots)

    def _record_stats(self, context, program, before, removed: int,
                      hints: int = 0):
        stats = {"pass": self.name, "ops_before": len(before),
                 "ops_after": len(program.ops), "removed": removed,
                 "hints": hints,
                 "op_class_delta": op_class_delta(before, program.ops)}
        if context is not None:
            context.attrs.setdefault("program_pass_log", []).append(stats)
        program.pass_log.append(stats)


@_program_pass("program_cse")
class ProgramCSEPass(ProgramPassBase):
    """Common-subexpression elimination keyed on (op name, structural fn
    identity incl. closures, input ids, non-tensor arguments) — see
    graph.run_cse."""

    def _apply_single_impl(self, main_program, startup_program, context):
        before = list(main_program.ops)
        main_program.ops, removed = run_cse(before,
                                            self._roots(main_program,
                                                        context))
        self._record_stats(context, main_program, before, removed)


@_program_pass("program_constant_fold")
class ProgramConstantFoldPass(ProgramPassBase):
    """Fold ops whose inputs are all constants (not placeholders, not
    parameters, not registered buffers, not writeback targets): capture
    already computed their values eagerly, so the op is dropped and its
    outputs become replay externals."""

    def _apply_single_impl(self, main_program, startup_program, context):
        before = list(main_program.ops)
        placeholder_ids = {id(t)
                           for t in main_program.placeholders.values()}
        protected = {id(tgt) for tgt, _ in main_program.writebacks} \
            | set(main_program.buffers)
        main_program.ops, removed = run_constant_fold(
            before, placeholder_ids, protected)
        self._record_stats(context, main_program, before, removed)


@_program_pass("program_dce")
class ProgramDCEPass(ProgramPassBase):
    """Dead-op elimination: drop ops whose outputs reach no fetch and
    no writeback source."""

    def _apply_single_impl(self, main_program, startup_program, context):
        before = list(main_program.ops)
        main_program.ops, removed = run_dce(before,
                                            self._roots(main_program,
                                                        context))
        self._record_stats(context, main_program, before, removed)


@_program_pass("program_claim_fused_kernels")
class ProgramClaimFusedKernelsPass(ProgramPassBase):
    """Let the fused kernel CLAIM the flagged norm→matmul chains: each
    accepted claim replaces the two records with ONE record replaying
    through ``ops.fused_decode.norm_matmul`` (K6d on the card).  Claims
    are validated numerically against the capture-time values before
    acceptance — see graph.run_claim_fused_kernels."""

    def _apply_single_impl(self, main_program, startup_program, context):
        before = list(main_program.ops)
        main_program.ops, claimed = run_claim_fused_kernels(
            before, self._roots(main_program, context))
        main_program.fusion_hints = (list(main_program.fusion_hints)
                                     + claimed)
        self._record_stats(context, main_program, before, len(claimed),
                           hints=len(claimed))


@_program_pass("program_fuse")
class ProgramFusePass(ProgramPassBase):
    """Compose single-consumer op chains into one replay record each
    and annotate the norm+matmul / rope+QKV chains the fused kernels can
    claim."""

    def _apply_single_impl(self, main_program, startup_program, context):
        before = list(main_program.ops)
        main_program.ops, removed = run_fuse(
            before, self._roots(main_program, context))
        # hints describe the CAPTURED chains (pre-rewrite indices);
        # chains already claimed by the kernel-claim pass are kept
        hints = collect_fusion_hints(before)
        main_program.fusion_hints = (list(main_program.fusion_hints)
                                     + hints)
        self._record_stats(context, main_program, before, removed,
                           hints=len(hints))


@_program_pass("program_remat_hints")
class ProgramRematHintPass(ProgramPassBase):
    """Remat + donation placement hints (annotation only).  Incompatible
    with the explicit recompute pass: user-placed checkpoints and
    heuristic remat hints would fight over the same activations."""

    _incompatible = ["auto_parallel_recompute"]

    def _apply_single_impl(self, main_program, startup_program, context):
        before = list(main_program.ops)
        main_program.remat_hints = collect_remat_hints(before)
        main_program.donation_hints = collect_donation_hints(main_program)
        self._record_stats(
            context, main_program, before, 0,
            hints=len(main_program.remat_hints)
            + len(main_program.donation_hints))


# ---------------------------------------------------------------------------
# pipeline runner
# ---------------------------------------------------------------------------

def pipeline_names(flag_value: str) -> Tuple[str, ...]:
    """A ``FLAGS_program_passes`` value -> pass-name tuple ('' -> empty;
    '1'/'default' -> the default pipeline)."""
    v = (flag_value or "").strip()
    if not v:
        return ()
    if v.lower() in ("1", "true", "on", "default", "auto"):
        return DEFAULT_PIPELINE
    names = tuple(p.strip() for p in v.split(",") if p.strip())
    for n in names:
        if n not in PROGRAM_PASSES:
            raise ValueError(
                f"FLAGS_program_passes names unknown pass {n!r}; "
                f"registered program passes: {sorted(PROGRAM_PASSES)}")
    return names


def run_program_passes(program: Program, fetches: Sequence,
                       names: Optional[Sequence[str]] = None,
                       label: str = "", strategy=None,
                       context: Optional[PassContext] = None
                       ) -> Tuple[Program, Dict[str, Any]]:
    """Apply the pipeline to a COPY of ``program`` (the original and
    every _OpRecord stay untouched), emitting one ``graph_pass`` event
    per pass.  ``fetches`` are the replay roots (fetch tensors; the
    runner adds the program's writeback sources itself).  The report
    holds the per-pass stats."""
    from ...observability import events
    names = tuple(names) if names is not None else DEFAULT_PIPELINE
    opt = program._copy()
    context = context or PassContext(strategy=strategy)
    context.attrs["program_roots"] = (
        {id(t) for t in fetches}
        | {id(src) for _, src in program.writebacks})
    label = label or f"program{program._id}"
    n0 = len(opt.ops)
    manager = PassManager([new_pass(n) for n in names])
    manager.apply(opt, None, context)
    per_pass = context.attrs.get("program_pass_log", [])
    for st in per_pass:
        events.emit("graph_pass", pass_name=st["pass"], program=label,
                    ops_before=st["ops_before"],
                    ops_after=st["ops_after"], removed=st["removed"],
                    hints=st["hints"],
                    op_class_delta=st["op_class_delta"] or None)
    report = {
        "program": label,
        "passes": per_pass,
        "ops_before": n0, "ops_after": len(opt.ops),
        "reduction_pct": round(100.0 * (n0 - len(opt.ops)) / n0, 2)
        if n0 else 0.0,
        "op_class_delta": op_class_delta(program.ops, opt.ops),
    }
    return opt, report


# ---------------------------------------------------------------------------
# the shared decode-capture harness
# ---------------------------------------------------------------------------

def capture_decode_program(model, input_ids, feed_name: str = "token"):
    """Capture ONE KV-cache decode step of an autoregressive model as a
    Program: the prefill runs eagerly to build the cache, the last
    position's argmax is the next token, then the step (token in, logits
    and every layer's updated ``(k, v)`` out) is recorded.  Returns
    ``(program, feed_names, fetch_tensors, token)`` ready for
    ``Program.build_replay`` / ``run_program_passes``; the prefill's
    cache tensors are the replay's externals."""
    with torch.no_grad():
        logits, past = model(input_ids, use_cache=True)
        tok = logits[:, -1].argmax(-1, keepdim=True)
    prog = Program()
    prog.add_placeholder(feed_name, tok)
    with capture_ops(prog):
        step_logits, new_past = model(tok, past=past, use_cache=True)
    fetches = [step_logits]
    for kv in new_past:
        fetches.extend(kv)
    return prog, [feed_name], fetches, tok
