"""CLI for paddle_tpu_torch.observability; a copy of
``paddle_tpu/observability/__main__.py``.

    python -m paddle_tpu_torch.observability snapshot [--prometheus]
    python -m paddle_tpu_torch.observability tail [--dir D] [-n N] [--kind K]
    python -m paddle_tpu_torch.observability report [--dir D]
    python -m paddle_tpu_torch.observability trace TRACE_ID [--dir D] [--json]
    python -m paddle_tpu_torch.observability watchdog [--dir D]
        [--baseline B] [--perf-model [DIR]] [--tolerance T]
        [--min-samples N] [--warn-only]

``snapshot`` dumps the process metrics registry (mostly useful from a
REPL/test process — a fresh CLI process has empty counters; the live
serving surface is ``GET /metrics``).  ``tail`` and ``report`` read the
JSONL event log under ``--dir`` (default: ``FLAGS_observability_dir``).
``report`` aggregates step/compile/checkpoint/dispatch/fault records
into the operator's one-screen view of a run, including per-kind
duration p50/p90/p99 columns (bucket-interpolated quantiles via the
shared ``HistogramValue``).  ``trace`` reconstructs one request's span
tree (queue → admit → batch-step links → finish) from the log alone
and pretty-prints the timeline.  ``watchdog`` is the SLO regression
gate: per-kind duration baselines from ``--baseline`` (or the log's
own first half when omitted) checked against the observed log — or,
with ``--perf-model [DIR]``, observed durations checked against the
learned performance model's predictions (``tuning.learned``; flags
divergence on shapes no baseline log ever saw and emits
``perf_regression`` events) — exit 0 clean, 3 on regression, so CI
can gate on it.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

from .events import read_events
from .metrics import HistogramValue, TIME_BUCKETS, default_registry


def _resolve_dir(arg: Optional[str]) -> Optional[str]:
    if arg:
        return arg
    import os
    env = os.environ.get("FLAGS_observability_dir")
    if env:
        return env
    try:
        from ..flags import get_flag
        return get_flag("observability_dir") or None
    except Exception:
        return None


def cmd_snapshot(args) -> int:
    reg = default_registry()
    if args.prometheus:
        sys.stdout.write(reg.prometheus_text())
    else:
        print(json.dumps(reg.snapshot(), indent=2, sort_keys=True))
    return 0


def cmd_tail(args) -> int:
    d = _resolve_dir(args.dir)
    if not d:
        print("no event log: pass --dir or set FLAGS_observability_dir",
              file=sys.stderr)
        return 2
    kinds = [args.kind] if args.kind else None
    recs = read_events(d, kinds=kinds)
    for rec in recs[-args.n:]:
        print(json.dumps(rec, sort_keys=True))
    return 0


def _fmt_table(rows: List[List[str]], header: List[str]) -> str:
    widths = [max(len(str(r[i])) for r in [header] + rows)
              for i in range(len(header))]
    def line(cells):
        return "  ".join(str(c).ljust(w) for c, w in zip(cells, widths))
    out = [line(header), line(["-" * w for w in widths])]
    out.extend(line(r) for r in rows)
    return "\n".join(out)


def aggregate(recs: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Reduce an event stream to the report's summary dict (pure, so
    tests can assert on it without parsing table text)."""
    steps = [r for r in recs if r.get("kind") == "step"]
    step_hist = HistogramValue(TIME_BUCKETS)
    eps = []
    for r in steps:
        if isinstance(r.get("step_time_s"), (int, float)):
            step_hist.observe(r["step_time_s"])
        if isinstance(r.get("examples_per_sec"), (int, float)):
            eps.append(r["examples_per_sec"])
    compiles = [r for r in recs if r.get("kind") == "compile"]
    saves = [r for r in recs if r.get("kind") == "ckpt_save"]
    restores = [r for r in recs if r.get("kind") == "ckpt_restore"]
    commits = [r for r in recs if r.get("kind") == "ckpt_commit"]
    faults = [r for r in recs if r.get("kind") == "fault"]
    restarts = [r for r in recs if r.get("kind") == "elastic_restart"]
    tuning = [r for r in recs if r.get("kind") == "tuning_cache"]
    ops: Dict[str, int] = {}
    for r in recs:
        if r.get("kind") == "dispatch_summary":
            for op, n in (r.get("ops") or {}).items():
                ops[op] = ops.get(op, 0) + int(n)
    tuning_by_event: Dict[str, int] = {}
    for r in tuning:
        ev = r.get("event", "?")
        tuning_by_event[ev] = tuning_by_event.get(ev, 0) + 1
    # per-kind duration quantiles through the shared bucket-
    # interpolated HistogramValue (the same estimator /metrics
    # exports), instead of mean-only rows
    from . import watchdog as _watchdog
    durations: Dict[str, Dict[str, Any]] = {}
    for key, samples in sorted(
            _watchdog.collect_durations(recs).items()):
        h = HistogramValue(TIME_BUCKETS)
        for s in samples:
            h.observe(s)
        durations[key] = {"count": h.count, "avg": round(h.avg, 6),
                          "p50": round(h.quantile(0.5), 6),
                          "p90": round(h.quantile(0.9), 6),
                          "p99": round(h.quantile(0.99), 6)}
    return {
        "events": len(recs),
        "runs": len({r.get("run") for r in recs}),
        "steps": {
            "count": len(steps),
            "first": steps[0].get("step") if steps else None,
            "last": steps[-1].get("step") if steps else None,
            "last_loss": next((r["loss"] for r in reversed(steps)
                               if isinstance(r.get("loss"),
                                             (int, float))), None),
            "step_time": step_hist.summary(),
            "examples_per_sec_avg":
                round(sum(eps) / len(eps), 3) if eps else None,
        },
        "compile": {
            "count": len(compiles),
            "total_s": round(sum(r.get("dur_s", 0.0) or 0.0
                                 for r in compiles), 3),
        },
        "checkpoint": {
            "saves": len(saves),
            "save_s_avg": round(sum(r.get("dur_s", 0.0) or 0.0
                                    for r in saves)
                                / len(saves), 4) if saves else None,
            "commits": len(commits),
            "restores": len(restores),
            "restore_skipped": sum(int(r.get("skipped", 0) or 0)
                                   for r in restores),
        },
        "faults": [(r.get("point"), r.get("occurrence"),
                    r.get("fault_kind")) for r in faults],
        "elastic_restarts": len(restarts),
        "tuning_cache": tuning_by_event,
        "dispatch": {
            "total": sum(ops.values()),
            "top_ops": sorted(ops.items(), key=lambda kv: -kv[1])[:10],
        },
        "durations": durations,
    }


def cmd_report(args) -> int:
    d = _resolve_dir(args.dir)
    if not d:
        print("no event log: pass --dir or set FLAGS_observability_dir",
              file=sys.stderr)
        return 2
    recs = read_events(d)
    agg = aggregate(recs)
    if args.json:
        print(json.dumps(agg, indent=2, sort_keys=True))
        return 0
    st = agg["steps"]
    h = st["step_time"]
    rows = [
        ["events", agg["events"], ""],
        ["runs", agg["runs"], ""],
        ["steps", st["count"],
         f"ids {st['first']}..{st['last']}" if st["count"] else ""],
        ["step_time_s", h["avg"],
         f"p50 {h['p50']}  p90 {h['p90']}  n {h['count']}"],
        ["examples/sec", st["examples_per_sec_avg"] or "-", ""],
        ["last_loss", st["last_loss"] if st["last_loss"] is not None
         else "-", ""],
        ["compiles", agg["compile"]["count"],
         f"total {agg['compile']['total_s']}s"],
        ["ckpt saves", agg["checkpoint"]["saves"],
         f"avg {agg['checkpoint']['save_s_avg']}s"
         if agg["checkpoint"]["saves"] else ""],
        ["ckpt restores", agg["checkpoint"]["restores"],
         f"skipped {agg['checkpoint']['restore_skipped']} torn"],
        ["faults", len(agg["faults"]),
         "; ".join(f"{p}@{o}={k}" for p, o, k in agg["faults"])],
        ["restarts", agg["elastic_restarts"], ""],
        ["tuning_cache", sum(agg["tuning_cache"].values()),
         " ".join(f"{k}={v}"
                  for k, v in sorted(agg["tuning_cache"].items()))],
        ["dispatched ops", agg["dispatch"]["total"],
         " ".join(f"{op}×{n}"
                  for op, n in agg["dispatch"]["top_ops"][:5])],
    ]
    print(_fmt_table([[str(a), str(b), str(c)] for a, b, c in rows],
                     ["metric", "value", "detail"]))
    if agg["durations"]:
        print("\nper-kind durations (s):")
        drows = [[key, d["count"], d["p50"], d["p90"], d["p99"]]
                 for key, d in sorted(agg["durations"].items())]
        print(_fmt_table([[str(c) for c in r] for r in drows],
                         ["kind", "count", "p50", "p90", "p99"]))
    return 0


def cmd_trace(args) -> int:
    from . import tracing
    d = _resolve_dir(args.dir)
    if not d:
        print("no event log: pass --dir or set FLAGS_observability_dir",
              file=sys.stderr)
        return 2
    recs = read_events(d)
    mine = tracing.trace_records(recs, args.trace_id)
    if not mine:
        print(f"trace {args.trace_id!r} not found in {d}",
              file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(tracing.build_trace(recs, args.trace_id),
                         indent=2, sort_keys=True, default=str))
    else:
        print(tracing.render_trace(recs, args.trace_id))
    return 0


def cmd_watchdog(args) -> int:
    from . import watchdog
    d = _resolve_dir(args.dir)
    if not d:
        print("no event log: pass --dir or set FLAGS_observability_dir",
              file=sys.stderr)
        return 2
    recs = read_events(d)
    kw = dict(tolerance=args.tolerance, min_samples=args.min_samples,
              min_seconds=args.min_seconds)
    if args.perf_model is not None:
        from ..tuning import learned
        model = learned.load_model(args.perf_model or None)
        if model is None or not model.heads:
            print("no trained perf model: fit one with "
                  "paddle_tpu_torch.tuning.learned.fit_from_telemetry "
                  "and save_model first (looked in "
                  f"{args.perf_model or 'FLAGS_tuning_cache_dir'!r})",
                  file=sys.stderr)
            return 2
        findings = watchdog.model_check(recs, model, **kw)
        mode = "model"
    elif args.baseline:
        base_recs = read_events(args.baseline)
        baselines = watchdog.compute_baselines(
            base_recs, min_samples=args.min_samples)
        findings = watchdog.check(recs, baselines, **kw)
        mode = "baseline"
    else:
        findings = watchdog.self_check(recs, **kw)
        mode = "self"
    if args.json:
        print(json.dumps({"mode": mode, "events": len(recs),
                          "regressions": findings},
                         indent=2, sort_keys=True))
    else:
        for f in findings:
            ref = f.get("baseline_p50", f.get("predicted_p50"))
            print(f"REGRESSION {f['key']}: p50 {ref}s -> "
                  f"{f['observed_p50']}s (x{f['ratio']}, "
                  f"{'/'.join(f['stats'])} outside the "
                  f"{args.tolerance:+.0%} band)")
        print(f"watchdog[{mode}]: {len(recs)} event(s), "
              f"{len(findings)} regression(s)")
    if findings and not args.warn_only:
        return 3
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m paddle_tpu_torch.observability",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("snapshot", help="dump the metrics registry")
    p.add_argument("--prometheus", action="store_true",
                   help="text exposition format instead of JSON")
    p.set_defaults(fn=cmd_snapshot)
    p = sub.add_parser("tail", help="print the last N event records")
    p.add_argument("--dir", default=None)
    p.add_argument("-n", type=int, default=20)
    p.add_argument("--kind", default=None)
    p.set_defaults(fn=cmd_tail)
    p = sub.add_parser("report", help="aggregate the event log")
    p.add_argument("--dir", default=None)
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_report)
    p = sub.add_parser("trace", help="reconstruct and pretty-print one "
                                     "request's span tree")
    p.add_argument("trace_id")
    p.add_argument("--dir", default=None)
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_trace)
    p = sub.add_parser("watchdog", help="SLO regression gate over "
                                        "per-kind duration baselines "
                                        "(exit 3 on regression)")
    p.add_argument("--dir", default=None,
                   help="observed log (default FLAGS_observability_dir)")
    p.add_argument("--baseline", default=None,
                   help="baseline log dir/file; omitted: the observed "
                        "log's first half baselines its second half")
    p.add_argument("--tolerance", type=float, default=0.5)
    p.add_argument("--min-samples", type=int, default=3)
    p.add_argument("--min-seconds", type=float, default=1e-4)
    p.add_argument("--warn-only", action="store_true",
                   help="report regressions but exit 0")
    p.add_argument("--perf-model", nargs="?", const="", default=None,
                   metavar="DIR",
                   help="compare observed durations against the "
                        "learned perf model's predictions instead of "
                        "a historical baseline (DIR holds "
                        "perf_model.json; omit the value to use "
                        "FLAGS_tuning_cache_dir)")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_watchdog)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
