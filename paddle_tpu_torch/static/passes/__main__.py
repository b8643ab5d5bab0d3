"""``python -m paddle_tpu_torch.static.passes`` — the program-pass
pipeline on one captured decode step.

Builds GPT (``--model gpt``, default ``gpt3-1.3B``) or LLaMA (``--model
llama``, default ``llama2-7b``) in fp32 with random weights from a seed,
prefills a random prompt of ``--batch`` x ``--prompt`` tokens, captures the
next decode step with ``capture_decode_program``, runs the default
pipeline, and replays the captured and the optimized program on the same
token.  Prints one JSON object with the fields of the JAX package's
``bench.py`` ``_measure_program_passes``: op counts before and after,
``reduction_pct``, ``allclose`` (at ``check_equivalence``'s defaults
on the CPU, at ``CARD_TOL`` on the card), the fusion hints, each pass's
``removed``, and the replay ms before and after (``warm_step_delta_pct``
< 0 is faster): the medians of 10 host-clock times of one synchronised
replay, the two programs taking turns, after one warm replay each
(:func:`replay_times`), with their quartiles, the device and the kernel
launches of one replay (K6d is ``norm_matmul``).  Runs on the CUDA card
by default::

    python -m paddle_tpu_torch.static.passes [--model gpt|llama]
        [--preset NAME] [--batch 8] [--prompt 256] [--device cuda|cpu]

    python -m paddle_tpu_torch.static.passes --preset tiny --device cpu
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

_DEFAULT_PRESET = {"gpt": "gpt3-1.3B", "llama": "llama2-7b"}
PAIRS = 10


def replay_times(programs, feeds, fetches, tok, pairs, sync):
    """Host ms of one synchronised replay (no grad) of each program,
    ``pairs`` rounds in turns (the order reversed every other round) after
    one warm replay each: one list of times per program."""
    import torch
    runs = []
    for p in programs:
        pure, ext = p.build_replay(feeds, fetches)
        runs.append((pure, tuple(ext)))
    times = [[] for _ in runs]
    with torch.no_grad():
        for pure, ext in runs:
            pure((tok,), ext)
        sync()
        for i in range(pairs):
            order = list(range(len(runs)))
            for k in (order if i % 2 == 0 else order[::-1]):
                pure, ext = runs[k]
                t0 = time.perf_counter()
                pure((tok,), ext)
                sync()
                times[k].append(1e3 * (time.perf_counter() - t0))
    return times


def quartiles(ms):
    """(first quartile, median, third quartile) of a list of times."""
    q1, q2, q3 = statistics.quantiles(ms, n=4)
    return q1, q2, q3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--model", default="gpt", choices=sorted(_DEFAULT_PRESET))
    ap.add_argument("--preset", default=None,
                    help="default: gpt3-1.3B (gpt), llama2-7b (llama)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ...analysis.pass_check import CARD_TOL, check_equivalence
    from ...device import default_device
    from ...models import (GPTForPretraining, LlamaForCausalLM, gpt_config,
                           llama_config)
    from ...ops import fused_decode, layer_norm, rms_norm
    from . import capture_decode_program, run_program_passes

    dev = default_device(args.device)
    preset = args.preset or _DEFAULT_PRESET[args.model]
    if args.model == "gpt":
        cfg = gpt_config(preset, hidden_dropout_prob=0.0,
                         attention_dropout_prob=0.0)
        model = GPTForPretraining(cfg, device=dev, seed=0)
    else:
        cfg = llama_config(preset)
        model = LlamaForCausalLM(cfg, device=dev, seed=0)
    rs = np.random.RandomState(0)
    ids = torch.from_numpy(rs.randint(0, cfg.vocab_size,
                                      (args.batch, args.prompt))).to(dev)
    prog, feeds, fetches, tok = capture_decode_program(model, ids)
    opt, report = run_program_passes(prog, fetches,
                                     label=f"{args.model}_decode")
    tol = CARD_TOL if dev.type == "cuda" else {}
    equiv = check_equivalence(prog, opt, feeds, fetches, [tok], **tol)
    counters = (fused_decode.launches, layer_norm.launches,
                rms_norm.launches)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def launches(program):
        """The launches of one replay."""
        pure, ext = program.build_replay(feeds, fetches)
        before = [dict(c) for c in counters]
        with torch.no_grad():
            pure((tok,), tuple(ext))
        sync()
        moved = {}
        for b, c in zip(before, counters):
            moved.update({k: c[k] - b[k] for k in c if c[k] != b[k]})
        return moved

    before_launches, after_launches = launches(prog), launches(opt)
    ms_b, ms_a = (quartiles(t) for t in replay_times(
        (prog, opt), feeds, fetches, tok, PAIRS, sync))
    print(json.dumps({
        "program": f"{args.model}_decode_step", "preset": preset,
        "layers": cfg.num_layers, "batch": args.batch,
        "prompt": args.prompt,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu",
        "ops_before": report["ops_before"],
        "ops_after": report["ops_after"],
        "reduction_pct": report["reduction_pct"],
        "allclose": bool(equiv["allclose"]),
        "max_abs_err": equiv["max_abs_err"],
        "tolerance": tol or "check_equivalence defaults",
        "fusion_hints": len(opt.fusion_hints),
        "claimed": sum(bool(h.get("claimed")) for h in opt.fusion_hints),
        "removed_by_pass": {p["pass"]: p["removed"]
                            for p in report["passes"]},
        "replay_ms_before": ms_b[1], "replay_ms_after": ms_a[1],
        "warm_step_delta_pct": 100.0 * (ms_a[1] - ms_b[1]) / ms_b[1],
        "replay_ms_quartiles_before": [ms_b[0], ms_b[2]],
        "replay_ms_quartiles_after": [ms_a[0], ms_a[2]],
        "launches_per_replay_before": before_launches,
        "launches_per_replay_after": after_launches,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
