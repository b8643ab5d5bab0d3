"""``python -m paddle_tpu_torch.jit`` — the GPT pretraining step demo.

Runs ``bench.py``'s training configuration through the port: GPT
(``--preset``) at ``--seq`` x ``--batch``, amp O2 bf16 with fp32 master
weights, AdamW(1e-4, weight decay 0.01), the same random batch every
step, built with ``jit.train_step``.  Prints each step's loss and time
(host clock around a synchronised step), then tokens/s and, on the card,
MFU against the H100's 989 TFLOP/s bf16.  Runs on the CUDA card by
default::

    python -m paddle_tpu_torch.jit [--preset gpt3-1.3B] [--device cuda|cpu]
        [--batch 4] [--seq 2048] [--steps 4] [--profile]

``--profile`` traces the last step with ``torch.profiler`` and, on the
card, prints device time by kernel and the device's busy share of the
step.
"""
from __future__ import annotations

import argparse
import contextlib
import time

PEAK_BF16 = 989e12          # H100 SXM, dense bf16


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--preset", default="gpt3-1.3B")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--profile", action="store_true",
                    help="trace the last step with torch.profiler")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.jit import train_step
    from paddle_tpu_torch.models.gpt import GPTForPretraining, gpt_config
    from paddle_tpu_torch.serving.__main__ import _print_device_profile

    cfg = gpt_config(args.preset, max_position_embeddings=args.seq,
                     hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    model = GPTForPretraining(cfg, device=args.device, seed=0)
    opt = optimizer.AdamW(learning_rate=1e-4, parameters=model.parameters(),
                          weight_decay=0.01, multi_precision=True)
    model, opt = amp.decorate(models=model, optimizers=opt, level="O2",
                              dtype="bfloat16")

    def step_fn(m, ids, labels):
        with amp.auto_cast(enable=True, level="O2", dtype="bfloat16"):
            return m.loss_fn(m(ids), labels)

    step = train_step(model, None, opt, step_fn=step_fn)
    dev = model.device
    cuda = dev.type == "cuda"
    rs = np.random.RandomState(0)
    ids, labels = (torch.from_numpy(rs.randint(0, cfg.vocab_size,
                                               (args.batch, args.seq)))
                   .to(dev) for _ in range(2))
    n_params = sum(p.numel() for p in model.parameters())
    tokens = args.batch * args.seq
    for i in range(args.steps):
        last = i == args.steps - 1
        prof_ctx = contextlib.nullcontext()
        if args.profile and last:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if cuda:
                acts.append(ProfilerActivity.CUDA)
            prof_ctx = profile(activities=acts)
        with prof_ctx as prof:
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()  # noqa: PTL501 — the demo's step time
            loss = step(ids, labels)
            if cuda:
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0  # noqa: PTL501 — see t0
        line = (f"step {i}: loss {float(loss)} in {1e3 * dt:.2f} ms, "
                f"{tokens / dt:.1f} tokens/s")
        if cuda:
            line += (f", MFU {100 * 6 * n_params * tokens / dt / PEAK_BF16:.2f}"
                     f" % of 989 TFLOP/s bf16")
        print(line + (" (traced)" if args.profile and last else ""))
    if cuda:
        print(f"peak memory {torch.cuda.max_memory_allocated()} bytes, "
              f"batch {args.batch} x seq {args.seq}, {n_params} parameters; "
              f"{torch.cuda.get_device_name(0)}")
    if args.profile and cuda:
        _print_device_profile(prof, dt, top=20)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
