#!/usr/bin/env python3
"""On-chip smoke test of the PyTorch/H100 port (``paddle_tpu_torch``).

Run from the root of a checkout, on a machine with one CUDA card::

    python3 chip_smoke.py

It imports nothing of JAX or ``paddle_tpu``.  Phases, each failing
loudly with a non-zero exit:

1. device — require CUDA, print the card's name and power limit
   (``nvidia-smi``), turn TF32 off for float32 matmuls and convolutions;
2. build — compile every kernel of ``paddle_tpu_torch/ops/csrc`` with
   nvcc for sm_90a and print the build seconds and ptxas report;
3. K7 — the ragged paged attention kernel against its plain PyTorch
   version on the card, at serving shapes (page 16, head_dim 128, MHA
   16/16 and GQA 32/8, fp32 and bf16): error against the stated
   tolerance, exact zeros on the empty slot, kernel / plain / library
   (``scaled_dot_product_attention``, a yardstick only) times and the
   card's bound for the same work;
4. main path — GPT-3 1.3B (random weights from a seed, fp32) served by
   ``ServingEngine`` (max_batch 8, page 16): 8 requests, two sharing a
   64-token prefix, one sampled; every greedy request returns its 32
   tokens, the kernel ran exactly once per layer per step, the prefix
   cache hit, and the engine's step logits for a prompt match the dense
   forward.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.models.gpt import GPTForPretraining, gpt_config
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import ragged_paged_attention as rpa
from paddle_tpu_torch.serving import PagePool, Request, Scheduler
from paddle_tpu_torch.serving import ServingEngine

HBM_BYTES_PER_S = 3.35e12          # H100 SXM
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# K7 vs its plain version: fp32 online (kernel) and two-pass (plain)
# softmax sum in different orders; bf16 is compared in the working dtype,
# where one rounding step of an output below 4 is under 2e-2
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# engine step vs dense forward, fp32 over 24 layers: different GEMM
# shapes (cuBLAS splits) and softmax orders, logits of order 1
LOGITS_TOL = 2e-3
N_LAYERS = 24


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int) -> float:
    """Device time of one call, from CUDA events around ``iters`` calls.
    A sleep kernel queued first keeps the device busy while the host
    enqueues, so host overhead does not leak into the interval."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)   # ~0.1 s at the H100's clocks
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 3: K7 against its plain version
# ---------------------------------------------------------------------------

def make_case(kv_lens, q_lens, q_width, nh, nkv, dtype, seed, ps=16, hd=128):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    b = len(kv_lens)
    pages = [-(-k // ps) for k in kv_lens]
    ppseq = max(pages)
    n_pages = sum(pages) + 1
    perm = torch.randperm(n_pages, generator=g, device=dev)
    tables = torch.zeros(b, ppseq, dtype=torch.int32, device=dev)
    at = 0
    for i, n in enumerate(pages):
        tables[i, :n] = perm[at:at + n]
        at += n
    shape = (nkv, n_pages, ps, hd)
    kp = torch.randn(shape, generator=g, device=dev).to(dtype)
    vp = torch.randn(shape, generator=g, device=dev).to(dtype)
    q = torch.randn(b, q_width, nh, hd, generator=g, device=dev).to(dtype)
    i32 = dict(dtype=torch.int32, device=dev)
    return (q, kp, vp, torch.tensor(kv_lens, **i32),
            torch.tensor(q_lens, **i32), tables)


def bound(kv_lens, q_lens, q_width, nh, nkv, dtype, ps=16, hd=128):
    """Least time for the work: live K/V pages + valid q rows read once,
    the output written once; attended (row, position) pairs times 4*hd
    operations.  Returns (ms, "bytes" | "operations")."""
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = flops = 0
    for kv, ql in zip(kv_lens, q_lens):
        if ql:
            nbytes += 2 * nkv * (-(-kv // ps)) * ps * hd * item
            nbytes += ql * nh * hd * item
            for i in range(ql):
                flops += 4 * hd * nh * min(kv, kv - ql + i + 1)
    nbytes += len(kv_lens) * q_width * nh * hd * item
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def library_fn(q, kp, vp, kv_lens, q_lens, tables):
    """``scaled_dot_product_attention`` on K/V gathered densely from the
    pages beforehand, with the ragged causal mask (timed as a yardstick;
    the port never calls it)."""
    b, qw, nh, hd = q.shape
    nkv, _, ps, _ = kp.shape
    t = tables.shape[1] * ps
    k = kp[:, tables.long()].transpose(0, 1).reshape(b, nkv, t, hd) \
        .repeat_interleave(nh // nkv, dim=1)
    v = vp[:, tables.long()].transpose(0, 1).reshape(b, nkv, t, hd) \
        .repeat_interleave(nh // nkv, dim=1)
    qt = q.transpose(1, 2)
    kvpos = torch.arange(t, device=q.device)
    qpos = (kv_lens - q_lens)[:, None] + torch.arange(qw, device=q.device)
    mask = (kvpos[None, None, :] <= qpos[:, :, None]) \
        & (kvpos[None, None, :] < kv_lens[:, None, None])
    mask = mask[:, None]
    return lambda: F.scaled_dot_product_attention(qt, k, v, attn_mask=mask)


CASES = {
    # a full 300-token prefill, a decode at context 2048, an empty slot
    # and a 64-row chunk at context 1024; Q padded to the engine's bucket
    "mixed": dict(kv_lens=[300, 2048, 0, 1024], q_lens=[300, 1, 0, 64],
                  q_width=512),
    # decode of the main path's 8 requests midway through generation
    "decode": dict(kv_lens=[33, 80, 144, 216, 349, 528, 96, 96],
                   q_lens=[1] * 8, q_width=1),
    # decode of 8 sequences at the model's full context
    "decode-2048": dict(kv_lens=[2048] * 8, q_lens=[1] * 8, q_width=1),
}
HEADS = {"mha": (16, 16), "gqa": (32, 8)}


def check_k7():
    results = []
    seed = 0
    for case, spec in CASES.items():
        for heads, (nh, nkv) in HEADS.items():
            for dtype in (torch.float32, torch.bfloat16):
                seed += 1
                args = make_case(spec["kv_lens"], spec["q_lens"],
                                 spec["q_width"], nh, nkv, dtype, seed)
                before = rpa.launches
                out = rpa.ragged_paged_attention(*args)
                torch.cuda.synchronize()
                if rpa.launches != before + 1:
                    fail(f"K7 {case}: launches did not increase")
                ref = rpa.ragged_paged_attention_ref(*args)
                if out.dtype != dtype or out.shape != args[0].shape:
                    fail(f"K7 {case}: output {out.dtype} {out.shape}")
                if not torch.isfinite(out.float()).all():
                    fail(f"K7 {case}/{heads}/{dtype}: non-finite output")
                err = 0.0
                for b, ql in enumerate(spec["q_lens"]):
                    if ql:
                        d = (out[b, :ql].float() - ref[b, :ql].float())
                        err = max(err, d.abs().max().item())
                    # padding rows (and the empty slot) are exactly 0
                    if not (out[b, ql:] == 0).all():
                        fail(f"K7 {case}: padding rows of slot {b} "
                             "are not 0")
                    if ql == 0 and not (ref[b] == 0).all():
                        fail(f"K7 {case}: plain version's empty slot "
                             "is not 0")
                if err > TOL[dtype]:
                    fail(f"K7 {case}/{heads}/{dtype}: max abs err {err} > "
                         f"{TOL[dtype]}")
                ms = time_ms(lambda: rpa.ragged_paged_attention(*args), 20)
                plain_ms = time_ms(
                    lambda: rpa.ragged_paged_attention_ref(*args), 3)
                library_ms = time_ms(library_fn(*args), 10)
                bound_ms, bound_by = bound(spec["kv_lens"], spec["q_lens"],
                                           spec["q_width"], nh, nkv, dtype)
                row = dict(case=case, heads=heads,
                           dtype=str(dtype).replace("torch.", ""),
                           max_abs_err=err, tol=TOL[dtype], ms=ms,
                           plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=bound_ms, bound_by=bound_by)
                say("K7 " + json.dumps(row))
                results.append(row)
                del args, out, ref
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def serve_main_path():
    cfg = gpt_config("gpt3-1.3B", hidden_dropout_prob=0.0,
                     attention_dropout_prob=0.0)
    if cfg.num_layers != N_LAYERS:
        fail(f"gpt3-1.3B has {cfg.num_layers} layers")
    t0 = time.perf_counter()
    model = GPTForPretraining(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    say(f"model: gpt3-1.3B fp32, {n_params} parameters, built in "
        f"{time.perf_counter() - t0:.3f} s")
    rs = np.random.RandomState(0)
    v = cfg.vocab_size
    prompts = [rs.randint(0, v, (n,)).tolist()
               for n in (17, 64, 128, 200, 333, 512)]
    shared = rs.randint(0, v, (64,)).tolist()      # 4 full pages of 16
    prompts += [shared + rs.randint(0, v, (16,)).tolist() for _ in range(2)]
    temps = [0.0] * 8
    temps[2] = 0.8

    engine = ServingEngine(model, max_batch=8, page_size=16)
    pool_bytes = 2 * N_LAYERS * engine.pool.num_pages * 16 \
        * cfg.hidden_size * 4
    say(f"engine: {engine.pool.num_pages} pages of 16 x {N_LAYERS} layers, "
        f"pools {pool_bytes} bytes")
    rpa.launches = 0                 # count the main path's launches only
    t_start = time.perf_counter()
    engine.start()
    reqs = [engine.submit(p, max_new_tokens=32, temperature=t)
            for p, t in zip(prompts[:7], temps[:7])]
    # the 8th shares the 7th's prefix: submit it once the 7th's prompt
    # is in the prefix cache (after its first token)
    deadline = time.monotonic() + 600
    while reqs[6].first_token_at is None and not reqs[6].done:
        if time.monotonic() > deadline:
            fail("the 7th request produced no token in 600 s")
        time.sleep(0.001)
    reqs.append(engine.submit(prompts[7], max_new_tokens=32,
                              temperature=temps[7]))
    outs = [r.wait(timeout=600) for r in reqs]
    wall = time.perf_counter() - t_start
    engine.stop()
    launches = rpa.launches
    stats = engine.stats()
    say(f"engine stats: {json.dumps(stats)}")
    for i, (o, t) in enumerate(zip(outs, temps)):
        if len(o) != 32:
            fail(f"request {i} (temperature {t}) returned {len(o)} tokens")
        if not all(0 <= x < v for x in o):
            fail(f"request {i} returned a token outside the vocabulary")
    steps = stats["steps"]
    if launches != N_LAYERS * steps or stats["kernel_launches"] != launches:
        fail(f"K7 launches {launches} != {N_LAYERS} x {steps} steps "
             f"(engine counted {stats['kernel_launches']})")
    if stats["prefix_cache"]["hits"] < 1:
        fail(f"prefix cache scored no hit: {stats['prefix_cache']}")
    if stats["failed_steps"]:
        fail(f"{stats['failed_steps']} failed steps")
    n_tok = sum(len(o) for o in outs)
    ttft = [r.first_token_at - r.submitted_at for r in reqs]
    say(f"main path: {len(reqs)} requests, {n_tok} tokens in {wall:.3f} s "
        f"= {n_tok / wall:.1f} tokens/s; {steps} steps, "
        f"{1e3 * wall / steps:.2f} ms/step (wall/steps); TTFT mean "
        f"{1e3 * sum(ttft) / len(ttft):.1f} ms, max "
        f"{1e3 * max(ttft):.1f} ms; prefix cache {stats['prefix_cache']}")
    n_decode = steps - stats["prefill_steps"]
    say(f"main path: {stats['prefill_steps']} steps with prefill, "
        f"{1e3 * stats['prefill_step_s'] / max(stats['prefill_steps'], 1):.2f}"
        f" ms each; {n_decode} decode steps, "
        f"{1e3 * stats['decode_step_s'] / max(n_decode, 1):.2f} ms each "
        "(host clock around dispatch + token read)")
    say(f"main path: K7 launches {launches} = {N_LAYERS} x {steps} steps")
    del engine
    torch.cuda.empty_cache()
    check_step_logits(model, prompts[3])
    return launches


def check_step_logits(model, prompt):
    """The engine's ragged step (planned by its scheduler, on fresh
    pools) against the dense forward: last-row logits of a prefill."""
    ps = 16
    c = model.config
    nh = c.num_heads
    hd = c.hidden_size // nh
    ppseq = -(-c.max_position_embeddings // ps)
    pool = PagePool(num_pages=-(-len(prompt) // ps) + 1, page_size=ps)
    sched = Scheduler(pool, max_batch=8, max_pages_per_seq=ppseq)
    sched.submit(Request(prompt, max_new_tokens=1))
    plan, _, _ = sched.plan_step()
    dev = model.device
    shape = (nh, pool.num_pages, ps, hd)
    pools = [(torch.zeros(shape, device=dev), torch.zeros(shape, device=dev))
             for _ in range(c.num_layers)]
    params, step = model.build_ragged_decode_step()

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    logits, _ = step(params, put(plan.tok), put(plan.pos), pools,
                     put(plan.page_ids), put(plan.slots), put(plan.kv_lens),
                     put(plan.q_lens), put(plan.tables))
    dense = model(torch.tensor([prompt], device=dev))[0, -1]
    err = (logits[0] - dense).abs().max().item()
    if not torch.isfinite(logits[0]).all() or logits.shape[1] != \
            c.vocab_size:
        fail(f"step logits: shape {tuple(logits.shape)} or non-finite")
    say(f"step vs dense forward, prompt of {len(prompt)}: last-row logits "
        f"max abs err {err:.3e} (tol {LOGITS_TOL}; |logits| max "
        f"{dense.abs().max().item():.3f})")
    if err > LOGITS_TOL:
        fail(f"step logits differ from the dense forward by {err}")


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)}; matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}")

    build_s = _build.build_all()
    say(f"build: {build_s:.3f} s ({' '.join(_build.NVCC_FLAGS)})")
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"ptxas {name}: {line.strip()}")

    k7 = check_k7()
    launches = serve_main_path()

    # the kernel's line: the main path's shape (decode, MHA 16/16, fp32)
    row = next(r for r in k7 if (r["case"], r["heads"], r["dtype"])
               == ("decode", "mha", "float32"))
    say(json.dumps({"kernels": [{
        "name": "ragged_paged_attention",
        "route": "cuda",
        "source": "paddle_tpu_torch/ops/csrc/ragged_paged_attention.cu",
        "replaces": "paddle_tpu/ops/pallas/ragged_paged_attention.py:207",
        "launches": launches,
        "max_abs_err": row["max_abs_err"],
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
        "shape": "decode, B=8, Q=1, nh=nkv=16, hd=128, ps=16, fp32",
    }]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
