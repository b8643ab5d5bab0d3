"""CLI for the persistent tuning cache; the port of ``python -m
paddle_tpu.tuning``.

    python -m paddle_tpu_torch.tuning stats  [--dir DIR]
    python -m paddle_tpu_torch.tuning dump   [--dir DIR] [--kind K] [--json]
    python -m paddle_tpu_torch.tuning prune  [--dir DIR] [--kind K]
                                             [--older-than-days D]
    python -m paddle_tpu_torch.tuning fit    [--dir DIR] [--json]
                                             [--from-events OBS_DIR ...]
                                             [--min-samples N]
    python -m paddle_tpu_torch.tuning merge  MODEL_JSON ... [--out PATH]
                                             [--json]

``fit --from-events <obs-dir>`` (repeatable) trains the learned
performance model (``tuning.learned``) on the cache's measured timings
plus the JSONL event logs under each dir (the serving engine's
``batch_step`` records with their measured ``step_s``) and persists it
as the versioned ``perf_model.json`` that predicted-cost admission, the
fleet router and the SLO watchdog consult.  ``merge`` folds several
replicas' ``perf_model.json`` files into one fleet-wide model
(``serving.fleet.perf_merge``: sample-count-weighted head average,
version = max input + 1, atomic write); exit 2 on a missing or corrupt
input, with no output written.  ``--dir`` overrides
FLAGS_tuning_cache_dir.

Not ported: ``warm`` (the parser keeps it; it raises
``NotImplementedError``), which writes the TPU flash kernel's block
picks, and ``fit``'s refit of the analytic model's alpha multipliers
from the autotuner's flash timings.  The port's flash tiles are fixed
in ``ops/csrc/flash_attention.cu`` and it has no autotuner, so nothing
writes ``flash_blocks`` timings for either to read.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from .cache import TuningCache, get_cache


def _open_cache(args) -> TuningCache:
    if args.dir:
        return TuningCache(args.dir)
    cache = get_cache()
    if cache is None:
        sys.stderr.write("no cache directory: pass --dir or set "
                         "FLAGS_tuning_cache_dir\n")
        raise SystemExit(2)
    return cache


def cmd_stats(args) -> int:
    cache = _open_cache(args)
    rows = {k: sum(1 for _ in cache.entries(k)) for k in cache.kinds()}
    out = {"dir": cache.directory, "entries": rows,
           "counters": cache.stats()}
    print(json.dumps(out, indent=2, sort_keys=True))
    return 0


def cmd_dump(args) -> int:
    cache = _open_cache(args)
    records = list(cache.entries(args.kind))
    if args.json:
        print(json.dumps(records, indent=2, sort_keys=True))
        return 0
    for rec in records:
        print(f"[{rec.get('t', 0):.0f}] "
              f"{json.dumps(rec['key'], sort_keys=True)} -> "
              f"{json.dumps(rec['value'], sort_keys=True)}")
    print(f"{len(records)} entr{'y' if len(records) == 1 else 'ies'}")
    return 0


def cmd_prune(args) -> int:
    cache = _open_cache(args)
    max_age = args.older_than_days * 86400.0 \
        if args.older_than_days is not None else None
    n = cache.prune(kind=args.kind, max_age_s=max_age)
    print(f"pruned {n} entr{'y' if n == 1 else 'ies'}")
    return 0


def cmd_warm(args) -> int:
    raise NotImplementedError(
        "warm writes the TPU flash kernel's block picks; the port's flash "
        "tiles are fixed in ops/csrc/flash_attention.cu")


def cmd_fit(args) -> int:
    from . import learned
    cache = _open_cache(args)
    out = {}
    if args.from_events:
        perf_model, summary = learned.fit_from_telemetry(
            cache, args.from_events, min_samples=args.min_samples)
        out["perf_model"] = summary
        if perf_model.heads:
            path = learned.save_model(perf_model, cache.directory)
            out["perf_model_path"] = path
            out["perf_model_version"] = perf_model.version
    if not out.get("perf_model_version"):
        sys.stderr.write(
            "fit: nothing trainable — need --from-events dirs with "
            "enough batch_step/step telemetry\n")
        if out:
            print(json.dumps(out, indent=2 if args.json else None,
                             sort_keys=True))
        return 1
    print(json.dumps(out, indent=2 if args.json else None,
                     sort_keys=True))
    return 0


def cmd_merge(args) -> int:
    # stdlib-only path through serving.fleet.perf_merge: usable on a
    # machine that only has the JSON files (offline fleet logs)
    from ..serving.fleet import perf_merge
    try:
        models = perf_merge.load_models(args.models)
    except (OSError, ValueError, KeyError) as e:
        sys.stderr.write(f"merge: {type(e).__name__}: {e}\n")
        return 2
    merged = perf_merge.merge_models(models)
    out_path = args.out
    if not out_path:
        from . import learned
        cache = _open_cache(args)
        out_path = learned.model_path(cache.directory)
    perf_merge.save_merged(merged, out_path)
    summary = {
        "out": os.path.abspath(out_path),
        "version": merged.version,
        "sources": len(models),
        "source_versions": [m.version for m in models],
        "heads": {fam: head.stats.get("n_samples", 0)
                  for fam, head in sorted(merged.heads.items())},
    }
    print(json.dumps(summary, indent=2 if args.json else None,
                     sort_keys=True))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m paddle_tpu_torch.tuning",
                                 description=__doc__)
    ap.add_argument("--dir", default="",
                    help="cache directory (default: FLAGS_tuning_cache_dir)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("stats", help="entry counts + hit/miss counters")
    p = sub.add_parser("dump", help="print cache entries")
    p.add_argument("--kind", default=None)
    p.add_argument("--json", action="store_true")
    p = sub.add_parser("prune", help="drop entries")
    p.add_argument("--kind", default=None)
    p.add_argument("--older-than-days", type=float, default=None)
    p = sub.add_parser("warm", help="write analytic flash picks (not "
                                    "ported: raises NotImplementedError)")
    p.add_argument("--flash", action="append",
                   help="SQ,SK,D[,DTYPE,CAUSAL,BH] (repeatable)")
    p.add_argument("--standard", action="store_true",
                   help="also warm the standard transformer shapes")
    p.add_argument("--backend", default="")
    p.add_argument("--device-kind", default="")
    p = sub.add_parser("fit", help="with --from-events, train + persist "
                                   "the learned perf model")
    p.add_argument("--json", action="store_true")
    p.add_argument("--from-events", action="append", default=[],
                   metavar="OBS_DIR",
                   help="observability event-log dir (repeatable); "
                        "trains the learned perf model on these logs "
                        "plus the cache's measured timings")
    p.add_argument("--min-samples", type=int, default=8,
                   help="per-family sample floor below which a learned "
                        "head is skipped (default 8)")
    p = sub.add_parser("merge", help="merge per-replica "
                                     "perf_model.json files (sample-"
                                     "count-weighted head average, "
                                     "version bump, atomic write)")
    p.add_argument("models", nargs="+", metavar="MODEL_JSON",
                   help="two or more perf_model.json files (one per "
                        "replica / run)")
    p.add_argument("--out", default="",
                   help="output path (default: perf_model.json in "
                        "the cache dir)")
    p.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    return {"stats": cmd_stats, "dump": cmd_dump, "prune": cmd_prune,
            "warm": cmd_warm, "fit": cmd_fit,
            "merge": cmd_merge}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
