"""Replay-equivalence verification for program passes; counterpart of
``paddle_tpu/analysis/pass_check.py`` (the PTL601 gate).

A program pass (``static.passes``) that changes replay semantics gives
silently wrong numbers on every replay.  This module is its verifier:

* a RANDOMIZED program corpus (:func:`build_corpus`) — captured op traces
  seeded to contain exactly the structures the passes claim to handle:
  duplicate subexpressions (CSE), constant chains (folding), dead
  branches (DCE), single-consumer chains (fusion), a random menu of ops,
  and a writeback-carrying training tail (liveness roots);
* :func:`verify_pass` / :func:`verify_registered_passes` — apply each
  registered program pass (and the full default pipeline) to every corpus
  program and require the optimized replay to give allclose outputs ON
  FRESH FEED VALUES (stale capture-time values are the classic
  unsound-fold bug — replaying with the capture feeds would never catch
  it);
* a float64 re-scan: a ``TorchFunctionMode`` over the optimized replay
  counts the float64 tensors it makes, which must not exceed the
  original replay's.

Each verification emits a ``graph_pass`` event (op counts and
``allclose``), as the reference's does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

__all__ = ["Finding", "build_corpus", "replay_outputs", "check_equivalence",
           "verify_pass", "verify_registered_passes", "CARD_TOL"]

_PASS_FILE = "paddle_tpu_torch/static/passes/__init__.py"

# check_equivalence's tolerance for a replay on the card.  Its defaults
# hold where both replays run the same plain ops (the CPU); on the card a
# claimed record runs K6d where the captured step ran K2a or K4a and a
# cuBLAS product, summed in other orders, across every layer of a decode
# step.  chip_smoke.py phase 16 prints the sound readings and a control
# (a claim without the norm's bias) against it.
CARD_TOL = dict(rtol=1e-4, atol=1e-4)


@dataclass
class Finding:
    """One verification failure (``code`` is always ``PTL601``)."""
    code: str
    message: str
    file: str = _PASS_FILE


def _finding(message: str) -> Finding:
    return Finding("PTL601", message)


# ---------------------------------------------------------------------------
# randomized corpus
# ---------------------------------------------------------------------------

def _build_entry(seed: int) -> Dict[str, Any]:
    """One captured program with known-optimizable structure.  All
    tensors are 4x4 fp32 so every menu op composes; the RandomState
    makes the tail deterministic per seed."""
    from ..nn import functional as F
    from ..static.capture import Program, capture_ops

    rs = np.random.RandomState(seed)

    def t():
        return torch.from_numpy(rs.randn(4, 4).astype("float32"))

    prog = Program()
    x, y = t(), t()
    prog.add_placeholder("x", x)
    prog.add_placeholder("y", y)
    const = t()
    w = torch.nn.Parameter(t())

    with torch.no_grad(), capture_ops(prog):
        a = x + y
        b = x + y                            # duplicate: CSE target
        c = F.matmul(a, b)
        k = const * 2.0                      # constant chain: fold target
        k2 = k + const
        d = torch.tanh(c)                    # single-consumer chain: fuse
        e = d + k2
        dead = x * const                     # unreachable from any fetch
        dead = torch.tanh(dead)              # noqa: F841 — DCE target
        pool = [a, c, e, F.matmul(e, w)]
        menu = [
            lambda u, v: u + v,
            lambda u, v: u - v,
            lambda u, v: u * v,
            lambda u, v: F.matmul(u, v),
            lambda u, v: torch.tanh(u),
            lambda u, v: u * 0.5,
        ]
        for _ in range(int(rs.randint(3, 9))):
            f = menu[int(rs.randint(len(menu)))]
            u = pool[int(rs.randint(len(pool)))]
            v = pool[int(rs.randint(len(pool)))]
            pool.append(f(u, v))
        out = pool[-1]
        # a training-style tail: update math feeding ONLY a writeback
        g = out * w
        new_w = w - g * 0.1
    prog.writebacks.append((w, new_w))
    return {"program": prog, "feed_names": ["x", "y"],
            "fetches": [e, out], "feed_arrays": [t(), t()],
            "label": f"corpus{seed}"}


def build_corpus(n: int = 3, seed: int = 0) -> List[Dict[str, Any]]:
    return [_build_entry(seed + i) for i in range(n)]


# ---------------------------------------------------------------------------
# replay + equivalence
# ---------------------------------------------------------------------------

def replay_outputs(program, feed_names: Sequence[str], fetches,
                   feed_arrays) -> Tuple:
    """Eager replay (no grad) of ``program`` on ``feed_arrays``."""
    pure, externals = program.build_replay(feed_names, fetches)
    with torch.no_grad():
        return pure(tuple(feed_arrays), tuple(externals))


def check_equivalence(original, optimized, feed_names, fetches,
                      feed_arrays, rtol: float = 1e-5,
                      atol: float = 1e-6) -> Dict[str, Any]:
    want = replay_outputs(original, feed_names, fetches, feed_arrays)
    got = replay_outputs(optimized, feed_names, fetches, feed_arrays)
    max_err, ok = 0.0, len(want) == len(got)
    if ok:
        for a, b in zip(want, got):
            if a.shape != b.shape or a.dtype != b.dtype or \
                    not torch.allclose(a, b, rtol=rtol, atol=atol,
                                       equal_nan=True):
                ok = False
            if a.shape == b.shape and a.numel():
                max_err = max(max_err, float(
                    (a.double() - b.double()).abs().max()))
    return {"allclose": ok, "max_abs_err": max_err,
            "ops_before": len(original.ops),
            "ops_after": len(optimized.ops)}


class _F64Count(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        self.count += sum(isinstance(o, torch.Tensor)
                          and o.dtype in (torch.float64, torch.complex128)
                          for o in outs)
        return out


def _f64_tensors(program, feed_names, fetches, feed_arrays) -> int:
    """float64 tensors the replay makes (any torch call inside it)."""
    with _F64Count() as mode:
        replay_outputs(program, feed_names, fetches, feed_arrays)
    return mode.count


# ---------------------------------------------------------------------------
# pass verification (the PTL601 gate)
# ---------------------------------------------------------------------------

def verify_pass(name: str, corpus: Optional[List[dict]] = None,
                check_hazards: bool = True) -> List[Finding]:
    """Replay-equivalence + float64 verification of one registered pass
    over the corpus.  Returns findings (empty = verified)."""
    from ..observability import events
    from ..static.passes import run_program_passes
    findings: List[Finding] = []
    for entry in corpus or build_corpus():
        prog = entry["program"]
        opt, _ = run_program_passes(prog, entry["fetches"], names=[name],
                                    label=f"verify:{entry['label']}")
        args = (entry["feed_names"], entry["fetches"], entry["feed_arrays"])
        res = check_equivalence(prog, opt, *args)
        events.emit("graph_pass", pass_name=name,
                    program=f"verify:{entry['label']}",
                    ops_before=res["ops_before"],
                    ops_after=res["ops_after"],
                    removed=res["ops_before"] - res["ops_after"],
                    allclose=res["allclose"])
        if not res["allclose"]:
            findings.append(_finding(
                f"pass {name!r} broke replay equivalence on "
                f"{entry['label']} (max |err| {res['max_abs_err']:.3g}, "
                f"{res['ops_before']}->{res['ops_after']} ops)"))
            continue
        if check_hazards:
            before = _f64_tensors(prog, *args)
            after = _f64_tensors(opt, *args)
            if after > before:
                findings.append(_finding(
                    f"pass {name!r} made {after - before} more float64 "
                    f"tensor(s) in {entry['label']}'s replay"))
    return findings


def verify_registered_passes(corpus: Optional[List[dict]] = None,
                             check_hazards: bool = True) -> List[Finding]:
    """The full gate: every registered program pass individually, the
    default pipeline end-to-end, and a registration-coverage check (a
    pass registered outside the verified harness has no verifier
    invocation)."""
    from ..distributed.passes.pass_base import PASS_REGISTRY
    from ..observability import events
    from ..static.passes import (DEFAULT_PIPELINE, PROGRAM_PASSES,
                                 run_program_passes)
    corpus = corpus or build_corpus()
    findings: List[Finding] = []
    for name in sorted(set(PASS_REGISTRY)):
        if name.startswith("program_") and name not in PROGRAM_PASSES:
            findings.append(_finding(
                f"pass {name!r} is registered outside the verified "
                "program-pass harness (register it via static.passes so "
                "verify_registered_passes covers it)"))
    for name in PROGRAM_PASSES:
        findings.extend(verify_pass(name, corpus,
                                    check_hazards=check_hazards))
    # the composed pipeline can break in ways no single pass does
    # (ordering bugs, root-set drift between stages)
    for entry in corpus:
        prog = entry["program"]
        opt, report = run_program_passes(
            prog, entry["fetches"], names=DEFAULT_PIPELINE,
            label=f"verify-pipeline:{entry['label']}")
        res = check_equivalence(prog, opt, entry["feed_names"],
                                entry["fetches"], entry["feed_arrays"])
        events.emit("graph_pass", pass_name="pipeline",
                    program=f"verify-pipeline:{entry['label']}",
                    ops_before=res["ops_before"],
                    ops_after=res["ops_after"],
                    removed=res["ops_before"] - res["ops_after"],
                    op_class_delta=report["op_class_delta"] or None,
                    allclose=res["allclose"])
        if not res["allclose"]:
            findings.append(_finding(
                f"default pipeline broke replay equivalence on "
                f"{entry['label']} (max |err| {res['max_abs_err']:.3g})"))
        elif res["ops_after"] >= res["ops_before"]:
            findings.append(_finding(
                f"default pipeline removed nothing from {entry['label']} "
                f"({res['ops_before']} ops) — the corpus plants "
                "CSE/fold/DCE/fusion structure, so a zero-delta pipeline "
                "means a pass stopped firing"))
    return findings
