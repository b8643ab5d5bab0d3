"""``python -m paddle_tpu_torch.serving`` — continuous-batching demo.

Builds a randomly initialized GPT (seeded), starts the engine, submits a
handful of concurrent requests (two sharing a prompt prefix so the
prefix cache shows up in the stats) and prints the generated tokens plus
the engine counters.  Runs on the CUDA card by default::

    python -m paddle_tpu_torch.serving [--preset gpt3-1.3B]
        [--device cuda|cpu] [--dtype float32|bfloat16] [--requests N]
        [--max-new M] [--max-batch B] [--profile]

``--dtype`` is the KV pools' dtype.  ``--profile`` traces the served
window with ``torch.profiler`` and prints device time by kernel and the
device's busy share of the wall time.  HTTP serving (``--serve``) comes
in a later slice.
"""
from __future__ import annotations

import argparse
import contextlib
import time
from collections import defaultdict


def _print_device_profile(prof, wall_s: float, top: int = 12) -> None:
    """Device time by kernel over the traced window (CUPTI records every
    thread's kernels, the engine loop's included)."""
    from torch.autograd import DeviceType
    total = defaultdict(float)
    calls = defaultdict(int)
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            total[ev.name] += ev.time_range.elapsed_us()
            calls[ev.name] += 1
    busy_s = sum(total.values()) / 1e6
    print(f"profile: wall {wall_s:.6f} s, device busy {busy_s:.6f} s "
          f"({100 * busy_s / wall_s:.2f}%), {sum(calls.values())} device "
          f"activities")
    for name, us in sorted(total.items(), key=lambda kv: -kv[1])[:top]:
        print(f"profile: {us / 1e3:12.3f} ms {calls[name]:7d} x  "
              f"{name[:110]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--preset", default="gpt3-1.3B")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one)")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--profile", action="store_true",
                    help="trace the served window with torch.profiler")
    args = ap.parse_args(argv)

    import numpy as np

    from paddle_tpu_torch.models.gpt import GPTForPretraining, gpt_config
    from paddle_tpu_torch.serving import ServingEngine

    cfg = gpt_config(args.preset, hidden_dropout_prob=0.0,
                     attention_dropout_prob=0.0)
    model = GPTForPretraining(cfg, device=args.device, seed=0)
    rs = np.random.RandomState(0)
    vocab = cfg.vocab_size
    shared_prefix = rs.randint(0, vocab, (16,)).tolist()
    prompts = [shared_prefix + rs.randint(0, vocab, (4,)).tolist()
               for _ in range(2)]
    prompts += [rs.randint(0, vocab, (rs.randint(4, 24),)).tolist()
                for _ in range(max(0, args.requests - 2))]

    engine = ServingEngine(model, max_batch=args.max_batch, page_size=16,
                           dtype=args.dtype, device=args.device)
    prof_ctx = contextlib.nullcontext()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if engine.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof_ctx = profile(activities=acts)
    with prof_ctx as prof, engine:
        t0 = time.perf_counter()  # noqa: PTL501 — the demo's printed wall time
        reqs = [engine.submit(p, max_new_tokens=args.max_new)
                for p in prompts]
        for i, req in enumerate(reqs):
            try:
                toks = req.wait(timeout=300)
            except (RuntimeError, TimeoutError) as e:
                print(f"request {req.id}: prompt[{len(prompts[i])}] "
                      f"-> FAILED: {e}")
                continue
            print(f"request {req.id}: prompt[{len(prompts[i])}] -> {toks}")
        wall = time.perf_counter() - t0  # noqa: PTL501 — see t0
    stats = engine.stats()
    print(f"engine stats ({stats['device']}, {wall:.3f} s wall):", stats)
    if args.profile:
        _print_device_profile(prof, wall)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
