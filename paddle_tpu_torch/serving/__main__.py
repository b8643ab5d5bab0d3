"""``python -m paddle_tpu_torch.serving`` — continuous-batching demo.

Builds a randomly initialized GPT or LLaMA (seeded), starts the engine,
submits a handful of concurrent requests (two sharing a prompt prefix so
the prefix cache shows up in the stats) and prints the generated tokens
plus the engine counters.  Runs on the CUDA card by default::

    python -m paddle_tpu_torch.serving [--model gpt|llama] [--preset P]
        [--device cuda|cpu] [--dtype float32|bfloat16] [--requests N]
        [--max-new M] [--max-batch B] [--serve] [--profile]

``--preset`` defaults to ``gpt3-1.3B`` (GPT) or ``llama2-7b`` (LLaMA);
``tiny`` is either family's small preset.  ``--dtype`` is the KV pools'
dtype.  ``FLAGS_serving_fused_steps=4`` in the environment runs decode
as windows of 4 steps with one host read each.  ``--serve`` exposes the
engine over HTTP (``inference.serving.InferenceServer`` with
``FLAGS_serving_engine``) on loopback and drives it through ``POST
/generate`` (``generate_http``) instead of the in-process API.
``--profile`` traces the served window with ``torch.profiler`` and
prints device time by kernel and the device's busy share of the wall
time.  The fault-containment options ride the flags
(``FLAGS_fault_schedule``, ``FLAGS_serving_step_timeout_s``,
``FLAGS_serving_predicted_admission``): a quarantined or
deadline-cancelled request prints as FAILED with its ``error_kind``
while the other streams complete (the exit code is then 1).
"""
from __future__ import annotations

import argparse
import contextlib
import threading
import time
from collections import defaultdict

PRESETS = {"gpt": "gpt3-1.3B", "llama": "llama2-7b"}


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


def build_model(family: str, preset: str, device):
    """A seeded random model of ``family`` ("gpt" or "llama")."""
    if family == "llama":
        from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                                   llama_config)
        return LlamaForCausalLM(llama_config(preset), device=device, seed=0)
    from paddle_tpu_torch.models.gpt import GPTForPretraining, gpt_config
    cfg = gpt_config(preset, hidden_dropout_prob=0.0,
                     attention_dropout_prob=0.0)
    return GPTForPretraining(cfg, device=device, seed=0)


def _serve_http(engine, prompts, max_new: int):
    """Drive ``engine`` through ``POST /generate`` on loopback, one
    client thread a request; returns each request's tokens (or its
    exception)."""
    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.inference.serving import (InferenceServer,
                                                    generate_http)
    set_flags({"FLAGS_serving_engine": True})
    srv = InferenceServer(engine=engine,
                          max_in_flight=len(prompts)).start()
    print(f"serving on {srv.url}  (POST /generate)")
    outs = [None] * len(prompts)

    def run(i, ids):
        try:
            outs[i] = list(generate_http(srv.url, ids,
                                         max_new_tokens=max_new,
                                         timeout=600))
        except (RuntimeError, OSError) as e:
            outs[i] = e

    threads = [threading.Thread(target=run, args=(i, p))
               for i, p in enumerate(prompts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    srv.stop()
    return outs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--model", default="gpt", choices=sorted(PRESETS))
    ap.add_argument("--preset", default=None,
                    help="default: gpt3-1.3B / llama2-7b")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one)")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--serve", action="store_true",
                    help="drive the engine over HTTP (/generate)")
    ap.add_argument("--profile", action="store_true",
                    help="trace the served window with torch.profiler")
    args = ap.parse_args(argv)

    import numpy as np

    from paddle_tpu_torch.serving import ServingEngine

    preset = args.preset or PRESETS[args.model]
    model = build_model(args.model, preset, args.device)
    rs = np.random.RandomState(0)
    vocab = model.config.vocab_size
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
        kinds = [None] * len(prompts)   # each failed request's error_kind
        if args.serve:
            outs = _serve_http(engine, prompts, args.max_new)
        else:
            outs = []
            for i, req in enumerate([
                    engine.submit(p, max_new_tokens=args.max_new)
                    for p in prompts]):
                try:
                    outs.append(req.wait(timeout=300))
                except (RuntimeError, TimeoutError) as e:
                    # a quarantined / deadline-cancelled request fails
                    # alone — the remaining streams still complete
                    outs.append(e)
                    kinds[i] = req.error_kind
        wall = time.perf_counter() - t0  # noqa: PTL501 — see t0
    failed = 0
    for i, (p, toks) in enumerate(zip(prompts, outs)):
        if isinstance(toks, Exception):
            failed += 1
            print(f"request {i}: prompt[{len(p)}] -> FAILED ({kinds[i]}): "
                  f"{toks}")
        else:
            print(f"request {i}: prompt[{len(p)}] -> {toks}")
    stats = engine.stats()
    print(f"engine stats ({args.model} {preset}, {stats['device']}, "
          f"{wall:.3f} s wall):", stats)
    if args.profile:
        _print_device_profile(prof, wall)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
