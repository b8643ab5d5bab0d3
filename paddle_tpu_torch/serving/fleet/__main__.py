"""``python -m paddle_tpu_torch.serving.fleet`` — fleet demo + replica
worker; the port of ``python -m paddle_tpu.serving.fleet``.

Demo (default)::

    python -m paddle_tpu_torch.serving.fleet --replicas 2 [--requests N]
                                             [--max-new M]
                                             [--rolling-restart]
                                             [--device cpu]

Starts a :class:`~.replica.ReplicaSupervisor` with N GPT engine
replicas, a :class:`~.router.FleetRouter` in front of them, and drives
shared-prefix traffic through ``generate_http`` against the router —
then prints the fleet stats (affinity hits, resubmissions, live
replicas).  ``--rolling-restart`` performs a drain-aware rolling
restart mid-traffic to show that no stream truncates.  The widths
default to the reference's tiny GPT; ``--layers 24 --hidden 2048
--heads 16 --vocab 50304 --max-pos 2048`` serves GPT-3 1.3B.

Worker (``--worker``) is the per-replica process the supervisor
launches: build the model (random weights from ``--seed``), start the
engine + ``InferenceServer``, publish the bound URL to ``--port-file``
(atomic rename), then serve until SIGTERM — which drains in-flight
streams via the existing ``stop(drain_timeout)`` before exiting 0.

``--device`` takes the place of the reference's ``JAX_PLATFORMS``
forwarding: empty (the default) means the CUDA card, and a worker
raises without one; ``--device cpu`` runs on the CPU.  The demo passes
it on to its workers.
"""
from __future__ import annotations

import argparse
import os
import signal
import threading


def _build_model(args):
    from ...models.gpt import GPTConfig, GPTForPretraining
    cfg = GPTConfig(num_layers=args.layers, hidden_size=args.hidden,
                    num_heads=args.heads, vocab_size=args.vocab,
                    max_position_embeddings=args.max_pos,
                    hidden_dropout_prob=0.0,
                    attention_dropout_prob=0.0)
    return GPTForPretraining(cfg, device=args.device or None,
                             seed=args.seed)


def run_worker(args) -> int:
    from ...flags import set_flags
    from ...inference.serving import InferenceServer
    from .. import ServingEngine

    model = _build_model(args)
    set_flags({"FLAGS_serving_engine": True})
    engine = ServingEngine(model, max_batch=args.max_batch,
                           page_size=args.page_size,
                           device=args.device or None)
    engine.start()
    srv = InferenceServer(engine=engine, host=args.host, port=args.port,
                          max_in_flight=args.max_in_flight).start()
    # atomic publish: the supervisor polls for this file; a torn read
    # must be impossible
    tmp = args.port_file + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write(srv.url + "\n")
    os.replace(tmp, args.port_file)

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    stop.wait()
    # drain-aware shutdown: finish in-flight streams, then the engine
    srv.stop(drain_timeout=args.drain_timeout)
    engine.stop(drain=True, timeout=args.drain_timeout)
    return 0


def run_demo(args) -> int:
    import numpy as np

    from ...inference.serving import generate_http
    from . import FleetRouter, ReplicaSupervisor

    worker_args = ["--layers", str(args.layers),
                   "--hidden", str(args.hidden),
                   "--heads", str(args.heads),
                   "--vocab", str(args.vocab),
                   "--max-pos", str(args.max_pos),
                   "--max-batch", str(args.max_batch),
                   "--page-size", str(args.page_size),
                   "--seed", str(args.seed)]
    if args.device:
        worker_args += ["--device", args.device]
    sup = ReplicaSupervisor(args.replicas, worker_args=worker_args)
    print(f"launching {args.replicas} replica(s)...")
    with sup:
        router = FleetRouter(sup, page_size=args.page_size)
        with router:
            print(f"fleet router on {router.url}  (POST /generate)")
            rs = np.random.RandomState(0)
            shared = rs.randint(0, args.vocab,
                                (args.page_size,)).tolist()
            prompts = [shared + rs.randint(0, args.vocab,
                                           (4,)).tolist()
                       for _ in range(args.requests // 2)]
            prompts += [rs.randint(0, args.vocab,
                                   (rs.randint(4, 24),)).tolist()
                        for _ in range(args.requests
                                       - len(prompts))]

            def run(i, ids):
                toks = list(generate_http(
                    router.url, ids, max_new_tokens=args.max_new))
                print(f"request {i}: prompt[{len(ids)}] -> {toks}")

            threads = [threading.Thread(target=run, args=(i, p))
                       for i, p in enumerate(prompts)]
            for t in threads:
                t.start()
            if args.rolling_restart:
                print("rolling restart mid-traffic...")
                sup.rolling_restart()
            for t in threads:
                t.join()
            print("fleet stats:", router.fleet_stats())
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--worker", action="store_true",
                    help="run as a supervised replica process")
    ap.add_argument("--replica-id", default="0")
    ap.add_argument("--port-file", default="")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--max-in-flight", type=int, default=256)
    ap.add_argument("--drain-timeout", type=float, default=15.0)
    ap.add_argument("--rolling-restart", action="store_true",
                    help="demo: rolling restart mid-traffic")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--max-pos", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="",
                    help="torch device of the replicas' models and "
                         "engines (default: the CUDA card; 'cpu' for "
                         "the CPU)")
    args = ap.parse_args(argv)
    if args.worker:
        if not args.port_file:
            ap.error("--worker requires --port-file")
        return run_worker(args)
    return run_demo(args)


if __name__ == "__main__":
    raise SystemExit(main())
