"""The ranks of ``test_torch_collectives.py`` and
``test_torch_data_parallel.py``: one process per rank, started by the
port's launcher (``python -m paddle_tpu_torch.distributed.launch
--device cpu``) on gloo.  It imports torch and the port only (no JAX):
each rank runs every check of its mode and writes what it computed to
``OUT/rank<r>.npz`` (arrays) and ``OUT/rank<r>.json`` (the rest); the
test process holds them against the JAX package.

Usage: ``python tests/torch_dist_workers.py MODE OUT [WEIGHTS.npz ...]``,
MODE ``collectives``, ``train``, ``stage3`` (ZeRO stage 3: the tiny GPT
and the tiny LLaMA, ``GPT.npz LLAMA.npz``) or ``spawn`` (two gloo ranks
through ``distributed.spawn``, not the launcher).  :func:`launch` and
:func:`wait_ranks` start a group from a test and collect its results.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.distributed.communication import sanitizer
from paddle_tpu_torch.flags import set_flags

N_RANKS = 4
SEED = 1234
STEPS = 3
GLOBAL_BATCH, SEQ = 8, 32
LR = 1e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT_S = 240
JOIN_TIMEOUT_S = 120


def launch(mode, out, log_dir, *args, max_restart=0, script=None):
    """This script's ranks (or ``script``'s) under the port's launcher
    (``--device cpu``, no restart backoff), as a subprocess."""
    env = dict(os.environ, PYTHONPATH=REPO,
               PADDLE_ELASTIC_RESTART_BACKOFF="0")
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", str(N_RANKS), "--device", "cpu",
           "--log_dir", str(log_dir), "--max_restart", str(max_restart),
           str(script or os.path.abspath(__file__)), mode, str(out), *args]
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def wait_ranks(proc, out, log_dir):
    """Wait (bounded) for the group; every rank's arrays and info."""
    try:
        text, _ = proc.communicate(timeout=LAUNCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    logs = "".join(open(os.path.join(log_dir, f)).read()
                   for f in sorted(os.listdir(log_dir))
                   if f.startswith("workerlog"))
    assert proc.returncode == 0, text + logs
    arrays = [dict(np.load(os.path.join(out, f"rank{r}.npz")))
              for r in range(N_RANKS)]
    info = [json.load(open(os.path.join(out, f"rank{r}.json")))
            for r in range(N_RANKS)]
    return arrays, info


def collective_inputs():
    """The numpy inputs, the same in the test process: rank r's tensor
    is ``x[r]``; ``y[r, j]`` is rank r's j-th chunk of a list."""
    rs = np.random.RandomState(SEED)
    x = rs.randn(N_RANKS, 8, 3).astype(np.float32)
    y = rs.randn(N_RANKS, N_RANKS, 2, 3).astype(np.float32)
    return x, y


def run_collectives(out, r):
    x_np, y_np = collective_inputs()
    n = N_RANKS
    arrays, info = {}, {}

    def mine():
        return torch.tensor(x_np[r])

    for name, op in (("sum", dist.ReduceOp.SUM), ("max", dist.ReduceOp.MAX),
                     ("min", dist.ReduceOp.MIN), ("avg", dist.ReduceOp.AVG),
                     ("prod", dist.ReduceOp.PROD)):
        t = mine()
        dist.all_reduce(t, op=op)
        arrays[f"all_reduce_{name}"] = t.numpy()
    t = mine()
    work = dist.all_reduce(t, sync_op=False)
    work.wait()
    arrays["all_reduce_async"] = t.numpy()
    t = mine()
    dist.reduce(t, dst=1)
    arrays["reduce"] = t.numpy()
    lst = []
    dist.all_gather(lst, mine())
    arrays["all_gather"] = torch.cat(lst).numpy()
    lst = []
    dist.all_gather(lst, mine(), sync_op=False).wait()
    arrays["all_gather_async"] = torch.cat(lst).numpy()
    arrays["all_gather_functional"] = dist.all_gather(mine()).numpy()
    lst = []
    dist.gather(mine(), lst, dst=0)
    arrays["gather"] = torch.cat(lst).numpy()
    t = mine()
    dist.broadcast(t, src=2)
    arrays["broadcast"] = t.numpy()
    t = torch.zeros(2, 3)
    dist.scatter(t, [torch.tensor(c) for c in y_np[r]], src=1)
    arrays["scatter"] = t.numpy()
    for name, op in (("sum", dist.ReduceOp.SUM), ("avg", dist.ReduceOp.AVG),
                     ("max", dist.ReduceOp.MAX)):
        arrays[f"reduce_scatter_{name}"] = dist.reduce_scatter(
            mine(), op=op).numpy()
    t = torch.zeros(2, 3)
    dist.reduce_scatter(t, [torch.tensor(c) for c in y_np[r]])
    arrays["reduce_scatter_list"] = t.numpy()
    outs = []
    dist.alltoall(outs, [torch.tensor(c) for c in y_np[r]])
    arrays["alltoall"] = torch.stack(outs).numpy()
    arrays["alltoall_single"] = dist.alltoall_single(mine()).numpy()
    # a ring: rank r sends to r + 1 and receives from r - 1
    recv = torch.zeros(8, 3)
    if r % 2 == 0:
        dist.send(mine(), dst=(r + 1) % n)
        dist.recv(recv, src=(r - 1) % n)
    else:
        dist.recv(recv, src=(r - 1) % n)
        dist.send(mine(), dst=(r + 1) % n)
    arrays["send_recv"] = recv.numpy()
    recv = torch.zeros(8, 3)
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, mine(), (r + 1) % n),
        dist.P2POp(dist.irecv, recv, (r - 1) % n)])
    for w in works:
        w.wait()
    arrays["batch_isend_irecv"] = recv.numpy()
    dist.barrier()
    objs = []
    dist.all_gather_object(objs, {"rank": r})
    info["all_gather_object"] = objs
    objs = [f"from {r}", r]
    dist.broadcast_object_list(objs, src=3)
    info["broadcast_object_list"] = objs
    objs = []
    dist.scatter_object_list(objs, [f"to {j}" for j in range(n)], src=0)
    info["scatter_object_list"] = objs

    # subgroups: new_group and a mesh's axis groups
    g01 = dist.new_group([0, 1])
    g23 = dist.new_group([2, 3])
    mine_g = g01 if r < 2 else g23
    t = mine()
    dist.all_reduce(t, group=mine_g)
    other = g23 if r < 2 else g01
    untouched = mine()
    dist.all_reduce(untouched, group=other)        # not a member: no-op
    arrays["new_group_sum"] = t.numpy()
    arrays["new_group_nonmember"] = untouched.numpy()
    info["new_group"] = dict(ranks=mine_g.ranks, rank=mine_g.rank,
                             nranks=mine_g.nranks,
                             member_of_other=other.is_member(),
                             group_rank=dist.get_rank(mine_g))
    mesh = dist.build_mesh({"dp": 2, "mp": 2})
    t = mine()
    dist.all_reduce(t, group=mesh.group("mp"))
    arrays["mesh_mp_sum"] = t.numpy()
    t = mine()
    dist.all_reduce(t, group=mesh.group(("dp", "mp")))
    arrays["mesh_fused_sum"] = t.numpy()
    info["mesh"] = dict(mp=mesh.group("mp").ranks,
                        dp=mesh.group("dp").ranks, coord=mesh.coord(r))

    # all_reduce's gradient: the identity (c_allreduce_sum_grad)
    leaf = torch.tensor(x_np[r], requires_grad=True)
    y = leaf * float(r + 1)
    dist.all_reduce(y)
    (y * y).sum().backward()
    arrays["grad_value"] = y.detach().numpy()
    arrays["grad"] = leaf.grad.numpy()

    # the TCP store: a store of its own, served by rank 0
    port = [None]
    if r == 0:
        store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                              world_size=n, timeout=30)
        port = [store.port]
    dist.broadcast_object_list(port, src=0)
    if r != 0:
        store = dist.TCPStore("127.0.0.1", port[0], world_size=n,
                              timeout=30)
    if r == 0:
        store.set("greeting", "hello")
    st = {"get": store.get("greeting", timeout=30).decode()}
    st["add"] = store.add("counter", r + 1)
    dist.barrier()
    st["total"] = store.add("counter", 0)
    store.wait(["greeting"], timeout=5)
    try:
        store.wait(["never"], timeout=0.2)
        st["wait_timeout"] = "no raise"
    except TimeoutError:
        st["wait_timeout"] = "TimeoutError"
    try:
        store.get("never", timeout=0.2)
        st["get_timeout"] = "no raise"
    except TimeoutError:
        st["get_timeout"] = "TimeoutError"
    dist.barrier()
    if r == 0:
        store.delete_key("greeting")
    dist.barrier()
    try:
        store.wait(["greeting"], timeout=0.2)
        st["deleted"] = False
    except TimeoutError:
        st["deleted"] = True
    info["store"] = st
    dist.barrier()

    # the sanitizer: each case's collective must raise on every rank
    # before it launches, and the group must stay usable afterwards
    set_flags({"collective_sanitizer": True})
    cases = {
        "order": lambda: (dist.all_reduce(mine()) if r == 0
                          else dist.broadcast(mine(), src=0)),
        "shape": lambda: dist.all_reduce(
            torch.zeros(5 if r == 3 else 4, 3)),
        "dtype": lambda: dist.all_reduce(torch.zeros(
            4, dtype=torch.float64 if r == 1 else torch.float32)),
        "reduce_op": lambda: dist.all_reduce(
            mine(), op=dist.ReduceOp.MAX if r == 2 else dist.ReduceOp.SUM),
    }
    raised = {}
    for name, fn in cases.items():
        sanitizer.reset_sanitizer()
        try:
            fn()
            raised[name] = None
        except sanitizer.CollectiveMismatchError as e:
            raised[name] = [e.seq, e.rank_a, e.rank_b]
    for kind in ("truncate", "corrupt"):
        sanitizer.reset_sanitizer()
        set_flags({"fault_schedule": f"collective@2={kind}"})
        t = mine()
        try:
            dist.all_reduce(t)                 # call 1: agrees
            dist.all_reduce(mine())            # call 2: damaged
            raised[kind] = None
        except sanitizer.CollectiveMismatchError as e:
            raised[kind] = [e.seq, e.rank_a, e.rank_b]
        set_flags({"fault_schedule": ""})
    sanitizer.reset_sanitizer()
    t = mine()
    dist.all_reduce(t)                         # agreeing: runs
    arrays["after_sanitizer"] = t.numpy()
    set_flags({"collective_sanitizer": False})
    info["sanitizer"] = raised
    info["backend"] = dist.get_backend()
    return arrays, info


def _tiny(weights, use_recompute=False):
    from paddle_tpu_torch.models import (GPTForPretraining, gpt_config,
                                         load_paddle_tpu_state)
    model = GPTForPretraining(gpt_config(
        "tiny", hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
        use_recompute=use_recompute), device="cpu")
    load_paddle_tpu_state(model, weights)
    return model


def _adamw(model):
    from paddle_tpu_torch import optimizer
    return optimizer.AdamW(learning_rate=LR, parameters=model.parameters())


def _step_fn(m, ids, labels):
    return m.loss_fn(m(ids), labels)


def global_batch():
    """``tests/test_fleet_engine.py``'s ``_run_losses`` batch."""
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 512, (GLOBAL_BATCH, SEQ)).astype(np.int64)
    labels = rs.randint(0, 512, (GLOBAL_BATCH, SEQ)).astype(np.int64)
    return ids, labels


def _params(model):
    while hasattr(model, "_layers"):
        model = model._layers
    return {n: p.detach().float().numpy().copy()
            for n, p in model.named_parameters()}


def run_train(out, r, weights):
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.utils import (
        fused_allreduce_gradients, hybrid_parallel_util)
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.jit import train_step
    ids, labels = global_batch()
    k = GLOBAL_BATCH // N_RANKS
    local = (torch.tensor(ids[r * k:(r + 1) * k]),
             torch.tensor(labels[r * k:(r + 1) * k]))
    arrays, info = {}, {}

    def global_loss(loss):
        loss = loss.clone()
        dist.all_reduce(loss, op=dist.ReduceOp.AVG)
        return float(loss)

    # DataParallel over each rank's own rows (the upstream idiom), with
    # buckets small enough that several launch in turn
    model = dist.DataParallel(_tiny(weights), comm_buffer_size=0.1,
                              last_comm_buffer_size=0.05)
    opt = _adamw(model)
    step = train_step(model, None, opt, step_fn=_step_fn)
    info["dp"] = [global_loss(step(*local)) for _ in range(STEPS)]
    info["dp_buckets"] = len(model._reducer.buckets)
    dp_moments = {n: opt.state[p]["moment1"].numpy().copy()
                  for n, p in model._layers.named_parameters()}
    for n, a in _params(model).items():
        arrays[f"dp/{n}"] = a

    # ZeRO stages 1 and 2 over every rank
    for level in ("os", "os_g"):
        bare = _tiny(weights)
        model, sopt, _ = group_sharded_parallel(bare, _adamw(bare), level)
        step = train_step(model, None, sopt, step_fn=_step_fn)
        info[level] = [global_loss(step(*local)) for _ in range(STEPS)]
        for n, a in _params(model).items():
            arrays[f"{level}/{n}"] = a
        sd = sopt.state_dict()
        names = [n for n, _ in model._layers.named_parameters()]
        info[f"{level}_moment1_err"] = max(
            float(np.abs(sd["state"][i]["moment1"].numpy()
                         - dp_moments[n]).max())
            for i, n in enumerate(names))
        info[f"{level}_shard_elems"] = sum(
            int(s["m"].numel()) for s in sopt._state.values())
        info[f"{level}_bucket_elems"] = sum(
            b.numel for b in model._reducer.buckets)
        # the gathered state loads into a fresh sharded optimizer
        bare = _tiny(weights)
        _, fresh, _ = group_sharded_parallel(bare, _adamw(bare), level)
        fresh.set_state_dict(sd)
        again = fresh.state_dict()["state"]
        info[f"{level}_reload_err"] = max(
            float((again[i][k] - s[k]).abs().max())
            for i, s in sd["state"].items()
            for k in ("moment1", "moment2", "beta_pows"))

    # TrainStep(mesh=...) over the global batch, a bare model
    model = _tiny(weights)
    opt = _adamw(model)
    step = train_step(model, None, opt, mesh=dist.build_mesh({"dp": N_RANKS}),
                      step_fn=_step_fn)
    info["mesh"] = [float(step(ids, labels)) for _ in range(STEPS)]
    for n, a in _params(model).items():
        arrays[f"mesh/{n}"] = a

    # no_sync, then the manual average: the synced gradients
    model = dist.DataParallel(_tiny(weights))
    model.train()
    _step_fn(model, *local).backward()
    synced = {n: p.grad.clone() for n, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    with model.no_sync():
        _step_fn(model, *local).backward()
    fused_allreduce_gradients(list(model.parameters()), None)
    info["no_sync_err"] = max(
        float((p.grad - synced[n]).abs().max())
        for n, p in model.named_parameters())
    # broadcast_dp_parameters: every rank ends with rank 0's weights
    with torch.no_grad():
        for p in model.parameters():
            p.add_(float(r))
    hybrid_parallel_util.broadcast_dp_parameters(model, None)
    w = model._layers.gpt.final_ln.weight.detach().clone()
    dist.broadcast(w, src=0)
    info["broadcast_dp_equal"] = bool(torch.equal(
        w, model._layers.gpt.final_ln.weight))

    # fleet: dp 2 x sharding 2 (ZeRO stage 1 over the sharding group)
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 2, "sharding_degree": 2}
    fleet.init(is_collective=True, strategy=strategy, device="cpu")
    hcg = fleet.get_hybrid_communicate_group()
    model = fleet.distributed_model(_tiny(weights))
    opt = fleet.distributed_optimizer(_adamw(model))
    step = train_step(model, None, opt, mesh=hcg.mesh, step_fn=_step_fn)
    info["fleet"] = [float(step(ids, labels)) for _ in range(STEPS)]
    for n, a in _params(model).items():
        arrays[f"fleet/{n}"] = a
    info["fleet_groups"] = dict(
        dp=hcg.get_data_parallel_group().ranks,
        sharding=hcg.get_sharding_parallel_group().ranks,
        dp_sharding=hcg.get_dp_sharding_parallel_group().ranks,
        mode=hcg.get_parallel_mode(),
        sharded=opt._sharding is not None)
    return arrays, info


def _tiny_llama(weights, use_recompute):
    from paddle_tpu_torch.models import (LlamaForCausalLM, llama_config,
                                         load_paddle_tpu_state)
    model = LlamaForCausalLM(llama_config("tiny", use_recompute=use_recompute),
                             device="cpu")
    load_paddle_tpu_state(model, weights)
    return model


def stage3_batch(vocab):
    """``tests/test_fleet_engine.py``'s stage-3 batch at ``vocab``."""
    rs = np.random.RandomState(0)
    ids = rs.randint(0, vocab, (GLOBAL_BATCH, SEQ)).astype(np.int64)
    labels = rs.randint(0, vocab, (GLOBAL_BATCH, SEQ)).astype(np.int64)
    return ids, labels


# stage-3 runs: (model, use_recompute, batch): "rows" is each rank's own
# rows, "mesh" the global batch through TrainStep(mesh=dp 2 x sharding 2)
STAGE3_RUNS = {"gpt": ("gpt", False, "rows"),
               "gpt_rc": ("gpt", True, "mesh"),
               "llama_rc": ("llama", True, "mesh")}


def run_stage3(out, r, gpt_weights, llama_weights):
    """ZeRO stage 3 (``group_sharded_parallel(level="p_g_os")``) over the
    4 ranks: each run's global-mean losses, its full weights after
    ``STEPS`` steps (``state_dict``), the elements each rank holds
    between steps, the collectives per step, and a
    ``save_group_sharded_model`` round trip."""
    from paddle_tpu_torch.distributed.sharding import (
        group_sharded_parallel, save_group_sharded_model)
    from paddle_tpu_torch.jit import train_step
    arrays, info = {}, {}
    mesh = dist.build_mesh({"dp": 2, "sharding": 2})
    for tag, (kind, rc, feed) in STAGE3_RUNS.items():
        if kind == "gpt":
            bare = _tiny(gpt_weights, use_recompute=rc)
        else:
            bare = _tiny_llama(llama_weights, rc)
        numel = sum(p.numel() for p in bare.parameters())
        model, sopt, _ = group_sharded_parallel(bare, _adamw(bare), "p_g_os")
        red = model._reducer
        ids, labels = stage3_batch(bare.config.vocab_size)
        if feed == "mesh":
            step = train_step(model, None, sopt, mesh=mesh, step_fn=_step_fn)
            batch = (ids, labels)
        else:
            step = train_step(model, None, sopt, step_fn=_step_fn)
            k = GLOBAL_BATCH // N_RANKS
            batch = (ids[r * k:(r + 1) * k], labels[r * k:(r + 1) * k])
        losses, moved = [], []
        for _ in range(STEPS):
            before = (red.gathers, red.reduce_scatters)
            loss = step(*batch)
            if feed == "rows":
                loss = loss.clone()
                dist.all_reduce(loss, op=dist.ReduceOp.AVG)
            losses.append(float(loss))
            moved.append([red.gathers - before[0],
                          red.reduce_scatters - before[1]])
        info[tag] = losses
        layer_flats = sum(len(sg.flats) for sg in red.segments
                          if sg.module is not None)
        info[f"{tag}_layout"] = dict(
            moved=moved, segments=[sg.name for sg in red.segments],
            flats=len(red.buckets), layer_flats=layer_flats,
            param_elems=numel, n_params=len(list(bare.parameters())),
            flat_elems=sum(f.numel for f in red.buckets),
            shard_elems=sum(f.param_shard.numel() for f in red.buckets),
            grad_elems=sum(f.shard_grad.numel() for f in red.buckets),
            moment_elems=sum(s["m"].numel() for s in sopt._state.values()),
            held=sum(p.numel() for p in model.parameters()),
            tied=bare.config.tie_word_embeddings)
        sd = model.state_dict()
        full = model.get_all_parameters()
        info[f"{tag}_get_all_equal"] = all(
            torch.equal(p, sd[n]) for (n, _), p in
            zip(bare.named_parameters(), full))
        model._reducer.release()
        for n, v in sd.items():
            arrays[f"{tag}/{n}"] = v.numpy()
        # the sharded optimizer's gathered moments
        osd = sopt.state_dict()["state"]
        for i, (n, _) in enumerate(bare.named_parameters()):
            arrays[f"{tag}_moment1/{n}"] = osd[i]["moment1"].numpy()
            info.setdefault(f"{tag}_moment_shapes_ok", True)
            info[f"{tag}_moment_shapes_ok"] &= \
                list(osd[i]["moment1"].shape) == list(sd[n].shape)
        if tag == "gpt":
            # save, then load into a fresh stage-3 model on every rank
            save = os.path.join(out, "saved")
            save_group_sharded_model(model, save, sopt)
            dist.barrier()
            saved = torch.load(os.path.join(save, "model.pdmodel"))
            fresh_bare = _tiny(gpt_weights)
            fresh, fresh_opt, _ = group_sharded_parallel(
                fresh_bare, _adamw(fresh_bare), "p_g_os")
            fresh.set_state_dict(saved)
            again = fresh.state_dict()
            info["save_roundtrip"] = sorted(saved) == sorted(sd) and all(
                torch.equal(saved[n], sd[n]) and torch.equal(again[n], sd[n])
                for n in sd)
            info["saved_opt"] = os.path.exists(
                os.path.join(save, "model.pdopt"))
            # the gathered optimizer state loads into the fresh model's
            # sharded optimizer: each rank keeps its shards
            full_osd = sopt.state_dict()
            fresh_opt.set_state_dict(full_osd)
            again_osd = fresh_opt.state_dict()["state"]
            info["opt_reload_err"] = max(
                float((again_osd[i][k] - e[k]).abs().max())
                for i, e in full_osd["state"].items()
                for k in ("moment1", "moment2", "beta_pows"))
    return arrays, info


def _spawn_rank(out):
    dist.init_parallel_env(device="cpu")
    r = dist.get_rank()
    t = torch.tensor([float(r)])
    dist.all_reduce(t)
    with open(os.path.join(out, f"spawn{r}.json"), "w") as f:
        json.dump({"rank": r, "world": dist.get_world_size(),
                   "sum": float(t)}, f)
    dist.destroy_process_group()


def run_spawn(out):
    ctx = dist.spawn(_spawn_rank, args=(out,), nprocs=2, join=False,
                     backend="gloo")
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            sys.exit("spawn: the ranks did not finish")


def main():
    mode, out = sys.argv[1], sys.argv[2]
    if mode == "spawn":
        run_spawn(out)
        return
    dist.init_parallel_env(device="cpu")
    r = dist.get_rank()
    if mode == "collectives":
        arrays, info = run_collectives(out, r)
    elif mode == "stage3":
        arrays, info = run_stage3(out, r, dict(np.load(sys.argv[3])),
                                  dict(np.load(sys.argv[4])))
    else:
        weights = dict(np.load(sys.argv[3]))
        arrays, info = run_train(out, r, weights)
    np.savez(os.path.join(out, f"rank{r}.npz"), **arrays)
    with open(os.path.join(out, f"rank{r}.json"), "w") as f:
        json.dump(info, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
