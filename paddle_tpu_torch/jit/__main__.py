"""``python -m paddle_tpu_torch.jit`` — the pretraining step demo.

Runs a pretraining configuration through the port: GPT (``--model gpt``,
``bench.py``'s training configuration, default ``gpt3-1.3B`` at batch
4 x seq 2048) or LLaMA (``--model llama``, default ``llama2-7b`` at batch
2 x seq 4096), amp O2 bf16 with fp32 master weights, AdamW(1e-4, weight
decay 0.01), the same random batch every step, built with
``jit.train_step``.  ``--layers`` cuts the depth (the full llama2-7b
does not fit one 80 GB card with its O2 AdamW state).  Prints each
step's loss and time (host clock around a synchronised step), then
tokens/s and, on the card, MFU (6 x parameters x tokens per second
against the H100's 989 TFLOP/s bf16) and peak memory.  Runs on the CUDA
card by default::

    python -m paddle_tpu_torch.jit [--model gpt|llama] [--preset NAME]
        [--layers N] [--device cuda|cpu] [--batch B] [--seq S]
        [--steps 4] [--profile]

    python -m paddle_tpu_torch.jit --model llama --preset llama2-7b \
        --layers 8 --batch 2 --seq 4096 --profile

``--profile`` traces the last step with ``torch.profiler`` and, on the
card, prints device time by kernel and the device's busy share of the
step.
"""
from __future__ import annotations

import argparse
import contextlib
import time

PEAK_BF16 = 989e12          # H100 SXM, dense bf16
# --model: (preset, batch, seq) when not given
_DEFAULTS = {"gpt": ("gpt3-1.3B", 4, 2048), "llama": ("llama2-7b", 2, 4096)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--model", default="gpt", choices=sorted(_DEFAULTS))
    ap.add_argument("--preset", default=None,
                    help="default: gpt3-1.3B (gpt), llama2-7b (llama)")
    ap.add_argument("--layers", type=int, default=None,
                    help="default: the preset's depth")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one)")
    ap.add_argument("--batch", type=int, default=None,
                    help="default: 4 (gpt), 2 (llama)")
    ap.add_argument("--seq", type=int, default=None,
                    help="default: 2048 (gpt), 4096 (llama)")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--profile", action="store_true",
                    help="trace the last step with torch.profiler")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.jit import train_step
    from paddle_tpu_torch.models.gpt import GPTForPretraining, gpt_config
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_config
    from paddle_tpu_torch.serving.__main__ import _print_device_profile

    preset, batch, seq = _DEFAULTS[args.model]
    preset = args.preset or preset
    args.batch = args.batch or batch
    args.seq = args.seq or seq
    depth = {} if args.layers is None else dict(num_layers=args.layers)
    if args.model == "gpt":
        cfg = gpt_config(preset, max_position_embeddings=args.seq,
                         hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
                         **depth)
        model = GPTForPretraining(cfg, device=args.device, seed=0)
    else:
        cfg = llama_config(preset, **depth)
        model = LlamaForCausalLM(cfg, device=args.device, seed=0)
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
              f"{args.model} {preset}, {cfg.num_layers} layers, batch "
              f"{args.batch} x seq {args.seq}, {n_params} parameters; "
              f"{torch.cuda.get_device_name(0)}")
    if args.profile and cuda:
        _print_device_profile(prof, dt, top=40)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
