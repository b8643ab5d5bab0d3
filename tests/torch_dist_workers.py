"""The ranks of ``test_torch_collectives.py`` and
``test_torch_data_parallel.py``: one process per rank, started by the
port's launcher (``python -m paddle_tpu_torch.distributed.launch
--device cpu``) on gloo.  It imports torch and the port only (no JAX):
each rank runs every check of its mode and writes what it computed to
``OUT/rank<r>.npz`` (arrays) and ``OUT/rank<r>.json`` (the rest); the
test process holds them against the JAX package.

Usage: ``python tests/torch_dist_workers.py MODE OUT [WEIGHTS.npz ...]``,
MODE ``collectives``, ``train``, ``stage3`` (ZeRO stage 3: the tiny GPT
and the tiny LLaMA, ``GPT.npz LLAMA.npz``), ``tensor_parallel`` (mp, SP
and dp x sharding x mp runs, the mp layers, the SP hooks and the RNG
streams: ``GPT.npz LLAMA.npz LAYERS.npz``), ``segment_parallel`` (ring
and Ulysses attention, sep / cp runs and the fallback: ``DIR`` holding
their inputs), ``pipeline`` (``PipelineLayer`` under each schedule at
pp 4, the refusals, the GPT and LLaMA pipeline steps: ``DIR``), ``moe``
(the tiny ERNIE-MoE at ep 4 and dp 2 x ep 2, two per-rank controls and
the ragged ``global_scatter`` / ``global_gather``: ``DIR``),
``hybrid_clip`` (the global-norm clip and ``GradScaler`` under sharding
stages 1-3, mp with SP, mp x dp and the LLaMA pipeline steps, a
gradient poisoned on one rank: ``DIR``), ``auto_parallel`` (the
semi-auto round trips, the Linear-GELU-Linear stack at dp 2 x mp 2 and
dp 4, the refusals, the tiny ERNIE-MoE through ``Engine.fit`` at dp 2 x
ep 2 and ``Engine.tune``: ``DIR``) or
``spawn`` (two gloo ranks through
``distributed.spawn``, not the launcher).  :func:`launch` and
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


def launch(mode, out, log_dir, *args, max_restart=0, script=None,
           threads=None):
    """This script's ranks (or ``script``'s) under the port's launcher
    (``--device cpu``, no restart backoff), as a subprocess; ``threads``
    caps each rank's CPU threads (``OMP_NUM_THREADS``)."""
    env = dict(os.environ, PYTHONPATH=REPO,
               PADDLE_ELASTIC_RESTART_BACKOFF="0")
    if threads is not None:
        env["OMP_NUM_THREADS"] = str(threads)
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
            from paddle_tpu_torch import load
            saved = load(os.path.join(save, "model.pdmodel"))
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


# ---------------------------------------------------------------------------
# tensor and sequence parallelism
# ---------------------------------------------------------------------------

# the tiny GQA LLaMA of the tensor-parallel runs: 8 heads over 4 kv heads,
# so mp 4 splits neither
TP_LLAMA = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=8,
                num_kv_heads=4, intermediate_size=128,
                max_position_embeddings=64)
# tests/test_segment_parallel.py's LLaMA (GQA 4 / 2)
SEG_LLAMA = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
                 num_kv_heads=2, intermediate_size=128,
                 max_position_embeddings=64)
# run: (model, degrees, sequence_parallel)
TP_RUNS = {
    "gpt_mp4": ("gpt", dict(mp_degree=4), False),
    "gpt_dp2_mp2": ("gpt", dict(dp_degree=2, mp_degree=2), False),
    "gpt_mp4_sp": ("gpt", dict(mp_degree=4), True),
    "gpt_sh2_mp2": ("gpt", dict(dp_degree=1, sharding_degree=2,
                                     mp_degree=2), False),
    "llama_mp4": ("llama", dict(mp_degree=4), False),
    "llama_dp2_mp2": ("llama", dict(dp_degree=2, mp_degree=2), False),
    "llama_mp4_sp": ("llama", dict(mp_degree=4), True),
    "llama_sh2_mp2": ("llama", dict(dp_degree=1, sharding_degree=2,
                                         mp_degree=2), False),
}
# run: (model, degrees, heads): tests/test_segment_parallel.py's settings
SEG_RUNS = {
    "gpt_sep4": ("gpt", dict(sep_degree=4), 4),
    "gpt_cp4": ("gpt", dict(cp_degree=4), 4),
    "gpt_sep2_mp2": ("gpt", dict(sep_degree=2, mp_degree=2), 8),
    "gpt_cp2_mp2": ("gpt", dict(cp_degree=2, mp_degree=2), 8),
    "llama_sep2_mp2": ("llama", dict(sep_degree=2, mp_degree=2), None),
    "llama_cp2_mp2": ("llama", dict(cp_degree=2, mp_degree=2), None),
}


def _fleet_init(**degrees):
    from paddle_tpu_torch.distributed import fleet
    s = fleet.DistributedStrategy()
    s.hybrid_configs = dict(degrees)
    fleet.init(is_collective=True, strategy=s, device="cpu")
    return fleet.get_hybrid_communicate_group()


def _fleet_clear():
    from paddle_tpu_torch.distributed.fleet.base.topology import _clear_hcg
    _clear_hcg()


def tp_model(kind, weights, sp=False, heads=None, llama=None, **kw):
    """The tiny GPT or LLaMA built under the live topology, carried from
    the JAX weights (each rank its shards)."""
    from paddle_tpu_torch.models import (GPTForPretraining, LlamaConfig,
                                         LlamaForCausalLM, gpt_config,
                                         load_paddle_tpu_state)
    if kind == "gpt":
        extra = {} if heads is None else dict(num_heads=heads)
        extra.update(kw)
        model = GPTForPretraining(gpt_config(
            "tiny", hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
            sequence_parallel=sp, **extra), device="cpu")
    else:
        model = LlamaForCausalLM(LlamaConfig(**(llama or TP_LLAMA),
                                             sequence_parallel=sp),
                                 device="cpu")
    load_paddle_tpu_state(model, weights)
    return model


def full_params(model):
    """Every parameter's full value (split ones gathered over mp), fp32
    numpy; a collective call."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel.parallel_layers \
        import mp_layers
    while hasattr(model, "_layers"):
        model = model._layers
    return {n: mp_layers.gather_parameter(p.detach(), p).float().numpy()
            for n, p in model.named_parameters()}


def _train_fleet(kind, weights, batch, sp=False, heads=None, llama=None,
                 **kw):
    """3 steps of ``kind`` under the live topology through fleet's
    wrappers and ``TrainStep(mesh=...)`` on the global batch."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.jit import train_step
    hcg = fleet.get_hybrid_communicate_group()
    model = fleet.distributed_model(tp_model(kind, weights, sp, heads,
                                             llama, **kw))
    opt = fleet.distributed_optimizer(_adamw(model))
    step = train_step(model, None, opt, mesh=hcg.mesh, step_fn=_step_fn)
    losses = [float(step(*batch)) for _ in range(STEPS)]
    return model, losses


def tp_batch(vocab):
    """``tests/test_fleet_engine.py``'s ``_run_losses`` batch at
    ``vocab``."""
    rs = np.random.RandomState(0)
    return (rs.randint(0, vocab, (GLOBAL_BATCH, SEQ)).astype(np.int64),
            rs.randint(0, vocab, (GLOBAL_BATCH, SEQ)).astype(np.int64))


def seg_batch(vocab, seed):
    """``tests/test_segment_parallel.py``'s batch (GPT: seed 0, LLaMA:
    seed 1)."""
    rs = np.random.RandomState(seed)
    return (rs.randint(0, vocab, (GLOBAL_BATCH, SEQ)).astype(np.int64),
            rs.randint(0, vocab, (GLOBAL_BATCH, SEQ)).astype(np.int64))


def _stage3_of(model):
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    return group_sharded_parallel(model, _adamw(model), "p_g_os")


def run_tensor_parallel(out, r, gpt_weights, llama_weights, layers):
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        TensorParallel)
    from paddle_tpu_torch.distributed.fleet.meta_parallel.parallel_layers \
        import mp_layers, random as mp_random
    from paddle_tpu_torch.distributed.fleet.utils import (
        sequence_parallel_utils as spu)
    arrays, info = {}, {}
    for tag, (kind, degrees, sp) in TP_RUNS.items():
        hcg = _fleet_init(**degrees)
        weights = gpt_weights if kind == "gpt" else llama_weights
        vocab = 512 if kind == "gpt" else TP_LLAMA["vocab_size"]
        model, losses = _train_fleet(kind, weights, tp_batch(vocab), sp)
        info[tag] = losses
        info[f"{tag}_wrapped"] = type(model).__name__
        info[f"{tag}_groups"] = dict(
            mp=hcg.get_model_parallel_group().ranks,
            dp=hcg.get_data_parallel_group().ranks,
            sharding=hcg.get_sharding_parallel_group().ranks)
        full = full_params(model)
        if r == 0:
            for n, a in full.items():
                arrays[f"{tag}/{n}"] = a
        info[f"{tag}_held"] = sum(p.numel() for p in model.parameters())
        _fleet_clear()

    # the mp layers at mp 4 on the test's inputs and weights
    hcg = _fleet_init(mp_degree=4)
    refused = {}
    for case, build in (
            ("gqa_kv_heads", lambda: tp_model(
                "llama", llama_weights,
                llama=dict(TP_LLAMA, num_kv_heads=2))),
            ("stage3", lambda: _stage3_of(tp_model("gpt", gpt_weights)))):
        try:
            build()
            refused[case] = None
        except NotImplementedError as e:
            refused[case] = str(e)
    info["refused"] = refused
    # what the carry gave this rank
    for kind, weights in (("gpt", gpt_weights), ("llama", llama_weights)):
        model = tp_model(kind, weights)
        for n, p in model.named_parameters():
            if n in ("gpt.layers.0.attn.qkv_proj.weight",
                     "gpt.layers.0.attn.qkv_proj.bias",
                     "gpt.embeddings.word_embeddings.weight",
                     "gpt.layers.1.mlp.fc1.weight",
                     "gpt.layers.1.mlp.fc2.weight", "lm_head_weight"):
                arrays[f"carry/{n}"] = p.detach().numpy()
    g = hcg.get_model_parallel_group()
    x = torch.tensor(layers["x"], requires_grad=True)
    ids = torch.tensor(layers["ids"])
    emb = mp_layers.VocabParallelEmbedding(*layers["emb_w"].shape,
                                           device="cpu")
    col = mp_layers.ColumnParallelLinear(*layers["col_w"].shape,
                                         gather_output=True, device="cpu")
    col_split = mp_layers.ColumnParallelLinear(
        *layers["col_w"].shape, gather_output=False, device="cpu")
    row = mp_layers.RowParallelLinear(*layers["row_w"].shape,
                                      input_is_parallel=False, device="cpu")
    ce = mp_layers.ParallelCrossEntropy()
    with torch.no_grad():
        for m, w in ((emb, "emb_w"), (col, "col_w"), (col_split, "col_w"),
                     (row, "row_w")):
            m.weight.copy_(mp_layers.shard_of(torch.tensor(layers[w]),
                                              m.weight.split_axis, 1,
                                              g.rank, 4))
        for m in (col, col_split):
            m.bias.copy_(torch.tensor(layers["col_b"]).chunk(4)[g.rank])
        row.bias.copy_(torch.tensor(layers["row_b"]))
    e = emb(ids)
    y = col(x)
    ys = col_split(x)
    z = row(y)
    logits = torch.tensor(layers["logits"]).chunk(4, dim=-1)[g.rank] \
        .clone().requires_grad_(True)
    loss_rows = ce(logits, torch.tensor(layers["labels"]))
    total = (e * torch.tensor(layers["ge"])).sum() + \
        (z * torch.tensor(layers["gz"])).sum() + \
        (loss_rows * torch.tensor(layers["gl"])).sum()
    total.backward()
    vals = dict(emb=e, col=y, row=z, ce=loss_rows,
                col_split=mp_layers.gather_parameter(
                    ys.detach(), col_split.weight),
                dx=x.grad, dlogits=mp_layers.gather_parameter(
                    logits.grad, col_split.weight),
                demb=mp_layers.gather_parameter(emb.weight.grad, emb.weight),
                dcol=mp_layers.gather_parameter(col.weight.grad, col.weight),
                drow=mp_layers.gather_parameter(row.weight.grad, row.weight),
                drow_b=row.bias.grad)
    if r == 0:
        for k, v in vals.items():
            arrays[f"layers/{k}"] = v.detach().numpy()
    info["layers_split_shapes"] = dict(
        emb=list(emb.weight.shape), col=list(col.weight.shape),
        row=list(row.weight.shape))

    # the SP hooks: one backward of the SP model with and without them,
    # the LayerNorm / RMSNorm gradients against the model without SP
    for kind, weights in (("gpt", gpt_weights), ("llama", llama_weights)):
        vocab = 512 if kind == "gpt" else TP_LLAMA["vocab_size"]
        ids_np, labels_np = tp_batch(vocab)
        batch = (torch.tensor(ids_np), torch.tensor(labels_np))
        grads = {}
        for case in ("no_sp", "sp", "sp_unhooked"):
            if case == "sp_unhooked":
                saved = spu.register_sequence_parallel_allreduce_hooks
                import paddle_tpu_torch.models.gpt as tgpt
                import paddle_tpu_torch.models.llama as tllama
                tgpt.register_sequence_parallel_allreduce_hooks = \
                    tllama.register_sequence_parallel_allreduce_hooks = \
                    lambda *a, **k: None
            try:
                model = tp_model(kind, weights, sp=case != "no_sp")
            finally:
                if case == "sp_unhooked":
                    tgpt.register_sequence_parallel_allreduce_hooks = \
                        tllama.register_sequence_parallel_allreduce_hooks = \
                        saved
            model.train()
            _step_fn(model, *batch).backward()
            grads[case] = {n: p.grad.clone() for n, p in
                           model.named_parameters()
                           if spu.is_sequence_parallel_parameter(p)}
            if case == "no_sp":
                plain = {n: p.grad.clone()
                         for n, p in model.named_parameters()}
        marked = sorted(grads["sp"])
        info[f"sp_hooks_{kind}_marked"] = marked
        for case in ("sp", "sp_unhooked"):
            info[f"sp_hooks_{kind}_{case}_err"] = max(
                float((grads[case][n] - plain[n]).abs().max())
                for n in marked)
        info[f"sp_hooks_{kind}_scale"] = max(
            float(plain[n].abs().max()) for n in marked)

    # the RNG streams
    gseed, lseed = mp_random.model_parallel_random_seed(1234)
    tracker = mp_random.get_rng_state_tracker()
    draws = {}
    for name in ("global_seed", "local_seed"):
        with tracker.rng_state(name) as gen:
            draws[name] = torch.rand(8, generator=gen)
    gathered = {k: mp_layers._gather(v[None], 0, g).numpy().tolist()
                for k, v in draws.items()}
    info["rng"] = dict(seeds=[gseed, lseed], draws=gathered,
                       mp_rank=hcg.get_model_parallel_rank())

    # TensorParallel's broadcasts: replicated parameters from the mp
    # group's first rank, each rank's shards kept
    model = tp_model("gpt", gpt_weights)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(float(r))
    TensorParallel(model, hcg)
    qkv = torch.tensor(gpt_weights["gpt.layers.0.attn.qkv_proj.weight"])
    info["broadcast"] = dict(
        final_ln=float(model.gpt.final_ln.weight[0]),
        qkv_shift=float(model.gpt.layers[0].attn.qkv_proj.weight[0, 0])
        - float(mp_layers.shard_of(qkv, 1, 3, g.rank, 4)[0, 0]))
    _fleet_clear()
    return arrays, info


def run_segment_parallel(out, r, src):
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        segment_parallel)
    from paddle_tpu_torch.ops.ring_attention import ring_attention_bhsd
    from paddle_tpu_torch.ops.ulysses import ulysses_attention
    arrays, info = {}, {}
    attn = dict(np.load(os.path.join(src, "attn.npz")))
    world = dist.new_group(list(range(N_RANKS)))
    n = N_RANKS
    # the ring over [BH, S/n, D] chunks, causal and not, with gradients
    for causal in (False, True):
        q, k, v = (torch.tensor(attn[t]).chunk(n, dim=1)[r].clone()
                   .requires_grad_(True) for t in ("q", "k", "v"))
        o = ring_attention_bhsd(q, k, v, world, 0.125, causal)
        w = torch.tensor(attn["w"])
        (o * w).sum().backward()
        tag = f"ring_{'causal' if causal else 'full'}"
        for name, t in (("out", o), ("dq", q.grad), ("dk", k.grad),
                        ("dv", v.grad)):
            arrays[f"{tag}/{name}"] = t.detach().numpy()
    # Ulysses over [B, S/n, H, D]
    for causal in (False, True):
        q, k, v = (torch.tensor(attn[f"u{t}"]).chunk(n, dim=1)[r].clone()
                   .requires_grad_(True) for t in ("q", "k", "v"))
        o = ulysses_attention(q, k, v, world, 0.125, causal)
        (o * torch.tensor(attn["w"])).sum().backward()
        tag = f"ulysses_{'causal' if causal else 'full'}"
        for name, t in (("out", o), ("dq", q.grad), ("dk", k.grad),
                        ("dv", v.grad)):
            arrays[f"{tag}/{name}"] = t.detach().numpy()

    # sep / cp runs of tests/test_segment_parallel.py
    for tag, (kind, degrees, heads) in SEG_RUNS.items():
        _fleet_init(**degrees)
        if kind == "gpt":
            weights = dict(np.load(os.path.join(src, f"gpt{heads}.npz")))
            batch = seg_batch(512, 0)
        else:
            weights = dict(np.load(os.path.join(src, "llama.npz")))
            batch = seg_batch(SEG_LLAMA["vocab_size"], 1)
        before = dict(segment_parallel.launches)
        model, losses = _train_fleet(kind, weights, batch, heads=heads,
                                     llama=SEG_LLAMA)
        info[tag] = losses
        info[f"{tag}_routes"] = {k: segment_parallel.launches[k] - before[k]
                                 for k in before}
        full = full_params(model)
        if r == 0:
            for nme, a in full.items():
                arrays[f"{tag}/{nme}"] = a
        _fleet_clear()

    # the fallback: sep 4 over 6 heads (Ulysses needs heads % sep == 0)
    hcg = _fleet_init(sep_degree=4)
    import warnings
    weights = dict(np.load(os.path.join(src, "fallback.npz")))
    model = tp_model("gpt", weights, heads=6, hidden_size=48)
    ids = torch.zeros(GLOBAL_BATCH, SEQ, dtype=torch.long)
    s = SEQ // n
    before = dict(segment_parallel.launches)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        logits = model(ids[:, r * s:(r + 1) * s])
    info["fallback_warnings"] = [str(w.message) for w in rec]
    info["fallback_routes"] = {k: segment_parallel.launches[k] - before[k]
                               for k in before}
    g = hcg.get_sep_parallel_group()
    from paddle_tpu_torch.distributed.fleet.meta_parallel.parallel_layers \
        import mp_ops
    full = mp_ops._gather(logits.contiguous(), 1, g)
    if r == 0:
        arrays["fallback/logits"] = full.numpy()
    _fleet_clear()
    return arrays, info


# the pipeline runs: tests/test_pp_schedules.py's PipelineLayer (8 x
# Linear(8, 8), SGD lr 0.05, batches of 8 in 4 micro-batches) under each
# schedule at pp 4; the tiny GPT (4 layers) at dp 2 x pp 2 and the tiny GQA
# LLaMA (4 layers) at mp 2 x pp 2 through their pipeline steps
PP_MODES = ("FThenB", "1F1B", "ZBH1", "VPP")
PP_CLIP = 0.5                    # the pp 4 clip run's: below each norm
PP_LLAMA = dict(vocab_size=256, hidden_size=64, num_layers=4, num_heads=4,
                num_kv_heads=2, max_position_embeddings=128)


class PPLinear(torch.nn.Module):
    """``x @ weight + bias`` with Paddle's ``[in, out]`` weight."""

    def __init__(self, n_in, n_out):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.zeros(n_in, n_out))
        self.bias = torch.nn.Parameter(torch.zeros(n_out))

    def forward(self, x):
        return x @ self.weight + self.bias


class PPTied(torch.nn.Module):
    """``x @ weight``: a layer two stages share (``SharedLayerDesc``)."""

    def __init__(self, n_in, n_out):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.zeros(n_in, n_out))

    def forward(self, x):
        return x @ self.weight


def pp_loss(o, y):
    return (o - y).square().mean()


def pp_data(seed):
    """``tests/test_pp_schedules.py``'s ``_data(seed)``."""
    rs = np.random.RandomState(seed)
    return (rs.randn(8, 8).astype(np.float32),
            rs.randn(8, 8).astype(np.float32))


def pp_batch(vocab, seq):
    """``tests/test_pipeline_spmd.py``'s / ``test_llama.py``'s batch."""
    rs = np.random.RandomState(0)
    return (rs.randint(0, vocab, (GLOBAL_BATCH, seq)).astype(np.int64),
            rs.randint(0, vocab, (GLOBAL_BATCH, seq)).astype(np.int64))


def pp_shared_descs(fleet):
    """Layer 0 and layer 7 one ``PPTied`` (8 positions)."""
    tied = fleet.SharedLayerDesc("tied", PPTied, None, "weight", 8, 8)
    return [tied] + [fleet.LayerDesc(PPLinear, 8, 8) for _ in range(6)] + \
        [tied]


def _pp_layer_fleet(mode, degrees, weights, n_layers=8, shared=False):
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import load_stage_state
    s = fleet.DistributedStrategy()
    s.hybrid_configs = dict(degrees)
    s.pipeline_configs = {"micro_batch_size": 2, "accumulate_steps": 4,
                          "schedule_mode": mode}
    fleet.init(is_collective=True, strategy=s, device="cpu")
    pl = fleet.PipelineLayer(
        layers=pp_shared_descs(fleet) if shared else
        [fleet.LayerDesc(PPLinear, 8, 8) for _ in range(n_layers)],
        loss_fn=pp_loss, num_virtual_pipeline_stages=2 if mode == "VPP"
        else None)
    load_stage_state(pl, weights)
    return pl, fleet.distributed_model(pl)


def _used(opt, model):
    """The parameters this rank's optimizer stepped, by name, fp32 numpy
    (split ones gathered over mp: a collective call)."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel.parallel_layers \
        import mp_layers
    inner = getattr(opt, "_inner_opt", opt)
    return {n: mp_layers.gather_parameter(p.detach(), p).float().numpy()
            for n, p in model.named_parameters() if p in inner.state}


def run_pipeline(out, r, src):
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        gpt_pipeline_step)
    from paddle_tpu_torch.models import (GPTForPretraining, LlamaConfig,
                                         LlamaForCausalLM, gpt_config,
                                         llama_pipeline_step,
                                         load_paddle_tpu_state)
    arrays, info = {}, {}
    weights = dict(np.load(os.path.join(src, "pp.npz")))

    # PipelineLayer at pp 4 under each schedule
    for mode in PP_MODES:
        pl, model = _pp_layer_fleet(mode, dict(pp_degree=4), weights)
        g = fleet.get_hybrid_communicate_group().get_p2p_groups()
        info["p2p_groups"] = [g.prev_rank, g.next_rank] + [
            grp.ranks for grp in (g.send_next_group, g.send_prev_group,
                                  g.recv_next_group, g.recv_prev_group)]
        opt = optimizer.SGD(learning_rate=0.05, parameters=pl.parameters())
        info[f"pp4_{mode}"] = [float(model.train_batch(pp_data(i), opt))
                               for i in range(STEPS)]
        sched = model._host_sched
        info[f"pp4_{mode}_log"] = [list(e) for e in sched.event_log]
        info[f"pp4_{mode}_peak"] = sched.peak_live_residuals
        info[f"pp4_{mode}_retained"] = sched.peak_retained_graphs
        for n, p in pl.named_parameters():
            arrays[f"pp4_{mode}/{n}"] = p.detach().numpy().copy()
        _fleet_clear()

    # a layer shared by stages 0 and 3 (SharedLayerDesc): the first
    # step's summed gradient, then 3 steps through the hybrid optimizer
    shared = dict(np.load(os.path.join(src, "shared.npz")))
    shared["7._shared.weight"] = shared["0._shared.weight"]
    pl, model = _pp_layer_fleet("1F1B", dict(pp_degree=4), shared,
                                shared=True)
    opt = fleet.distributed_optimizer(
        optimizer.SGD(learning_rate=0.05, parameters=pl.parameters()))
    x, y = pp_data(0)
    model.forward_backward_pipeline((torch.tensor(x), torch.tensor(y)))
    pl.allreduce_shared_weight_gradients()
    for n, p in pl.named_parameters():
        if "_shared" in n:
            arrays[f"shared_grad/{n}"] = p.grad.numpy().copy()
    opt.clear_grad()
    info["pp4_shared"] = [float(model.train_batch(pp_data(i), opt))
                          for i in range(STEPS)]
    for n, p in pl.named_parameters():
        arrays[f"pp4_shared/{n}"] = p.detach().numpy().copy()
    _fleet_clear()

    # an explicit schedule with a live mp axis: refused, then (flag) run
    import warnings
    pl, model = _pp_layer_fleet("ZBH1", dict(pp_degree=2, mp_degree=2),
                                weights, n_layers=4)
    opt = optimizer.SGD(learning_rate=0.05, parameters=pl.parameters())
    try:
        model.train_batch(pp_data(0), opt)
        info["mp_refused"] = ""
    except RuntimeError as e:
        info["mp_refused"] = str(e)
    set_flags({"pp_allow_axis_fallback": True})
    try:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            info["mp_fallback_loss"] = float(model.train_batch(pp_data(0),
                                                               opt))
        info["mp_fallback_warnings"] = [str(w.message) for w in rec]
    finally:
        set_flags({"pp_allow_axis_fallback": False})
    _fleet_clear()
    # a global-norm clip at pp 4: each stage's share of the squared norm
    # summed over the pipeline, with a bare optimizer and the hybrid one
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    for wrap in ("bare", "hybrid"):
        pl, model = _pp_layer_fleet("1F1B", dict(pp_degree=4), weights)
        clip = ClipGradByGlobalNorm(PP_CLIP)
        opt = optimizer.SGD(learning_rate=0.05, parameters=pl.parameters(),
                            grad_clip=clip)
        if wrap == "hybrid":
            opt = fleet.distributed_optimizer(opt)
        tag = f"pp4_clip_{wrap}"
        info[tag], info[f"{tag}_norms"] = [], []
        for i in range(STEPS):
            info[tag].append(float(model.train_batch(pp_data(i), opt)))
            info[f"{tag}_norms"].append((float(clip.last_norm),
                                         float(clip.last_local_norm)))
        for n, p in pl.named_parameters():
            arrays[f"{tag}/{n}"] = p.detach().numpy()
        _fleet_clear()
    # what still waits: pp with sharding, sep or cp
    refused = {}
    for axis in ("sharding_degree", "sep_degree", "cp_degree"):
        try:
            _fleet_init(pp_degree=2, **{axis: 2})
            refused[axis] = ""
        except NotImplementedError as e:
            refused[axis] = str(e)
        _fleet_clear()
    info["pp_refused"] = refused

    # the tiny GPT at dp 2 x pp 2 (its head tied to the word embedding)
    hcg = _fleet_init(dp_degree=2, pp_degree=2)
    model = GPTForPretraining(gpt_config(
        "tiny", hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
        num_layers=4), device="cpu")
    load_paddle_tpu_state(model, dict(np.load(os.path.join(src,
                                                           "gpt.npz"))))
    opt = fleet.distributed_optimizer(_adamw(model))
    step = gpt_pipeline_step(model, opt, hcg.mesh, n_micro=4,
                             dp_axes=("dp",))
    batch = pp_batch(512, SEQ)
    info["gpt_dp2_pp2"] = [float(step(*batch)) for _ in range(STEPS)]
    for n, a in _used(opt, model).items():
        arrays[f"gpt_dp2_pp2/{n}"] = a
    info["gpt_tied_group"] = list(
        model.gpt.embeddings.word_embeddings.weight.pp_shared_group.ranks)
    _fleet_clear()

    # the tiny GQA LLaMA at mp 2 x pp 2, its stages on the mp layers
    hcg = _fleet_init(mp_degree=2, pp_degree=2)
    model = LlamaForCausalLM(LlamaConfig(**PP_LLAMA), device="cpu")
    load_paddle_tpu_state(model, dict(np.load(os.path.join(src,
                                                           "llama.npz"))))
    opt = _adamw(model)
    step = llama_pipeline_step(model, opt, hcg.mesh, n_micro=4,
                               dp_axes=("dp",))
    batch = pp_batch(PP_LLAMA["vocab_size"], 16)
    info["llama_mp2_pp2"] = [float(step(*batch)) for _ in range(STEPS)]
    used = _used(opt, model)
    if hcg.get_model_parallel_rank() == 0:
        for n, a in used.items():
            arrays[f"llama_mp2_pp2/{n}"] = a
    info["llama_blocks"] = [i for i, b in enumerate(model.llama.layers)
                            if any(True for _ in b.parameters())]
    _fleet_clear()
    return arrays, info


# the tiny ERNIE-MoE of tests/test_torch_expert_parallel.py: a capacity
# factor that drops tokens, the MoE clip below every step's norm
MOE_CFG = dict(hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
               capacity_factor=0.5)
MOE_CLIP = 0.05
MOE_RUNS = {"ep4": dict(ep_degree=4),
            "dp2_ep2": dict(dp_degree=2, ep_degree=2)}
MOE_CONTROLS = ("per_rank_capacity", "per_rank_aux")
# global_scatter / global_gather: rows rank s sends to expert e of rank d
MOE_A2A_EXPERTS = 2


def moe_batch(vocab):
    """The global batch (8 x 16); MLM labels kept at ~25 % in the first
    half of the rows and ~60 % in the second, so the two dp ranks of dp 2
    count unequally."""
    rs = np.random.RandomState(0)
    ids = rs.randint(0, vocab, (GLOBAL_BATCH, 16)).astype(np.int64)
    labels = ids.copy()
    keep = np.concatenate([np.full(GLOBAL_BATCH // 2, 0.25),
                           np.full(GLOBAL_BATCH // 2, 0.6)])[:, None]
    labels[rs.rand(GLOBAL_BATCH, 16) > keep] = -100
    return ids, labels


def moe_a2a_counts():
    """``C[s, d, e]``: the rows rank s sends to expert e of rank d."""
    return np.random.RandomState(3).randint(
        0, 4, (N_RANKS, N_RANKS, MOE_A2A_EXPERTS))


def moe_a2a_rows(s, counts):
    """Rank s's rows, ordered by destination rank then expert: each row
    ``[s, d, e, i]``."""
    rows = [[s, d, e, i] for d in range(N_RANKS)
            for e in range(MOE_A2A_EXPERTS) for i in range(counts[s, d, e])]
    return np.array(rows, np.float32).reshape(-1, 4)


def _moe_model(weights):
    from paddle_tpu_torch.models import (ErnieMoEForPretraining,
                                         ernie_moe_config,
                                         load_paddle_tpu_state)
    model = ErnieMoEForPretraining(ernie_moe_config("tiny", **MOE_CFG),
                                   device="cpu")
    load_paddle_tpu_state(model, weights)
    return model


def _moe_train(tag, hcg, weights, batch):
    """3 AdamW steps (the MoE clip) through ``train_step(mesh=...)``."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.incubate.distributed.models.moe import (
        ClipGradForMOEByGlobalNorm)
    from paddle_tpu_torch.jit import train_step
    model = _moe_model(weights)
    opt = optimizer.AdamW(learning_rate=LR, parameters=model.parameters(),
                          weight_decay=0.01,
                          grad_clip=ClipGradForMOEByGlobalNorm(MOE_CLIP))
    step = train_step(model, model.loss_fn, opt, mesh=hcg.mesh)
    return model, [float(step(*batch)) for _ in range(STEPS)]


def _dp_mean(loss, hcg):
    """A rank's loss share averaged over the dp group, as ``train_step``
    averages the ranks' losses."""
    from paddle_tpu_torch.distributed.communication import all_reduce
    t = loss.detach().float().clone()
    all_reduce(t, group=hcg.get_data_parallel_group())
    return t / hcg.get_data_parallel_world_size()


def run_moe(out, r, src):
    from paddle_tpu_torch.distributed.utils import (global_gather,
                                                    global_scatter)
    from paddle_tpu_torch.incubate.distributed.models.moe import (
        ClipGradForMOEByGlobalNorm, MoELayer, moe_layer)
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    arrays, info = {}, {}
    weights = dict(np.load(os.path.join(src, "ernie.npz")))
    batch = moe_batch(256)
    for tag, degrees in MOE_RUNS.items():
        hcg = _fleet_init(**degrees)
        info[f"{tag}_groups"] = dict(
            ep=hcg.get_expert_parallel_group().ranks,
            dp=hcg.get_data_parallel_group().ranks,
            ep_rank=hcg.get_expert_parallel_rank())
        model = _moe_model(weights)
        info[f"{tag}_experts"] = [blk.ffn.experts.indices()
                                  for blk in model.ernie.blocks]
        # the eval loss and the gate losses on this rank's rows
        dp, k = hcg.get_data_parallel_world_size(), \
            hcg.get_data_parallel_rank()
        rows = slice(k * GLOBAL_BATCH // dp, (k + 1) * GLOBAL_BATCH // dp)
        ids, labels = (torch.tensor(a[rows]) for a in batch)
        loss = _dp_mean(model.loss_fn(model(ids), labels), hcg)
        info[f"{tag}_eval"] = [float(loss)] + [
            float(g) for g in model.ernie.gate_losses()]
        if tag == "ep4":
            # the MoE clip's global norm after one backward; the plain
            # clip refuses expert parameters here
            model.train()
            model.loss_fn(model(ids), labels).backward()
            pg = [(p, p.grad) for p in model.parameters()]
            info["moe_norm"] = float(ClipGradForMOEByGlobalNorm(
                MOE_CLIP)._squared_norm(pg).sqrt())
            try:
                ClipGradByGlobalNorm(MOE_CLIP).scale(pg)
                info["plain_clip"] = None
            except NotImplementedError as e:
                info["plain_clip"] = str(e)
        model, info[tag] = _moe_train(tag, hcg, weights, batch)
        for n, p in model.named_parameters():
            arrays[f"{tag}/{n}"] = p.detach().numpy()
        if tag == "ep4":
            # the port's own init: each expert from its own generator
            from paddle_tpu_torch.models import (ErnieMoEForPretraining,
                                                 ernie_moe_config)
            own = ErnieMoEForPretraining(ernie_moe_config("tiny"),
                                         device="cpu")
            for n, p in own.named_parameters():
                arrays[f"own/{n}"] = p.detach().numpy()
        _fleet_clear()

    # the controls: capacity, or the aux loss, per dp rank
    hcg = _fleet_init(**MOE_RUNS["dp2_ep2"])
    real_group, real_plan = moe_layer.token_group, MoELayer._plan

    def local_plan(self, xf):
        cap = self._capacity(xf.shape[0], None)
        logits, _ = self.gate(xf)
        return moe_layer.route(logits, self.top_k, cap, None) + (cap,)

    def global_plan(self, xf):
        group = real_group()
        cap = self._capacity(xf.shape[0], group)
        logits, _ = self.gate(xf)            # the aux loss per rank
        return moe_layer.route(logits, self.top_k, cap, group) + (cap,)
    for ctl in MOE_CONTROLS:
        if ctl == "per_rank_capacity":
            MoELayer._plan = local_plan
        else:
            moe_layer.token_group = lambda: None
            MoELayer._plan = global_plan
        try:
            rows = slice(hcg.get_data_parallel_rank() * GLOBAL_BATCH // 2,
                         (hcg.get_data_parallel_rank() + 1) *
                         GLOBAL_BATCH // 2)
            model = _moe_model(weights)
            ids, labels = (torch.tensor(a[rows]) for a in batch)
            loss = _dp_mean(model.loss_fn(model(ids), labels), hcg)
            info[f"{ctl}_eval"] = [float(loss)] + [
                float(g) for g in model.ernie.gate_losses()]
            _, info[ctl] = _moe_train(ctl, hcg, weights, batch)
        finally:
            moe_layer.token_group, MoELayer._plan = real_group, real_plan
    _fleet_clear()

    # the ragged exchange against the numpy model, and its gradient
    counts = moe_a2a_counts()
    x = torch.tensor(moe_a2a_rows(r, counts), requires_grad=True)
    local = torch.tensor(counts[r].reshape(-1))
    glob = torch.tensor(counts[:, r, :].reshape(-1))
    y = global_scatter(x, local, glob)
    (y * (y.detach() * 2 + 1)).sum().backward()
    arrays["a2a/scatter"] = y.detach().numpy()
    arrays["a2a/gather"] = global_gather(y.detach(), local, glob).numpy()
    arrays["a2a/grad"] = x.grad.numpy()
    return arrays, info


# ---------------------------------------------------------------------------
# the hybrid global-norm clip and GradScaler (tests/test_torch_hybrid_clip.py)
# ---------------------------------------------------------------------------

# the tiny GQA LLaMA of every hybrid-clip run: 4 layers (pp 4), 8 heads
# over 4 (mp 4 splits neither)
HC_LLAMA = dict(TP_LLAMA, num_layers=4)
HC_CLIP = 0.5                    # below every step's global norm
HC_SCALE = 2.0 ** 10
HC_STEPS = 4
HC_POISON_STEP = 2               # rank HC_POISON_RANK's gradient is inf
HC_POISON_RANK = 3
# run: (model, degrees, how it is wrapped)
HC_RUNS = {
    "gpt_os": ("gpt", dict(dp_degree=2, sharding_degree=2), "fleet"),
    "gpt_os_g": ("gpt", dict(dp_degree=2, sharding_degree=2), "os_g"),
    "gpt_p_g_os": ("gpt", dict(dp_degree=2, sharding_degree=2), "p_g_os"),
    "llama_mp4_sp": ("llama", dict(mp_degree=4), "fleet"),
    "llama_mp2_dp2_sp": ("llama", dict(dp_degree=2, mp_degree=2), "fleet"),
    "llama_pp4": ("llama", dict(pp_degree=4), "pipeline"),
    "llama_mp2_pp2": ("llama", dict(mp_degree=2, pp_degree=2), "pipeline"),
}


def _state_tensors(model, opt):
    """Every tensor a step may move on this rank: its parameters (under
    stage 3 its flat shards) and its optimizer state (under sharding its
    shards' masters, moments and beta powers)."""
    red = getattr(model, "_reducer", None)
    if red is not None and red.mode == "stage3":
        ts = [f.param_shard for f in red.buckets]
    else:
        ts = [p.detach() for p in model.parameters()]
    sharded = getattr(opt, "_sharding", None) or (
        opt if hasattr(opt, "_reducer") else None)
    inner = getattr(opt, "_inner_opt", opt)
    states = sharded._state.values() if sharded is not None \
        else inner.state.values()
    return [t.clone() for t in ts] + [v.clone() for st in states
                                       for v in st.values()]


def _poison_rank(scaler, r, step_of):
    """Make this rank's ``scaler.unscale_`` set one element of its last
    gradient (or gradient shard) to inf at ``HC_POISON_STEP``, after the
    reductions: rank ``HC_POISON_RANK`` alone sees it."""
    unscale = scaler.unscale_

    def poisoned(opt):
        if step_of() == HC_POISON_STEP and r == HC_POISON_RANK:
            with torch.no_grad():
                opt._unscale_targets()[-1].view(-1)[0] = float("inf")
        unscale(opt)
    scaler.unscale_ = poisoned


def _hc_build(tag, gpt_w, llama_w):
    """One run's model, optimizer, step and clip under the live topology
    (``HC_RUNS``)."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.jit import train_step
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         llama_pipeline_step,
                                         load_paddle_tpu_state)
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    kind, degrees, wrap = HC_RUNS[tag]
    hcg = _fleet_init(**degrees)
    clip = ClipGradByGlobalNorm(HC_CLIP)
    scaler = amp.GradScaler(init_loss_scaling=HC_SCALE)
    if kind == "gpt":
        bare = tp_model("gpt", gpt_w)
        batch = global_batch()
    elif wrap == "pipeline":
        bare = LlamaForCausalLM(LlamaConfig(**HC_LLAMA), device="cpu")
        load_paddle_tpu_state(bare, llama_w)
        batch = tp_batch(HC_LLAMA["vocab_size"])
    else:
        bare = LlamaForCausalLM(LlamaConfig(
            **HC_LLAMA, sequence_parallel=True, use_recompute=True),
            device="cpu")
        load_paddle_tpu_state(bare, llama_w)
        batch = tp_batch(HC_LLAMA["vocab_size"])

    def adamw(m):
        return optimizer.AdamW(learning_rate=LR, parameters=m.parameters(),
                               grad_clip=clip)
    if wrap == "pipeline":
        opt = adamw(bare)
        step = llama_pipeline_step(bare, opt, hcg.mesh, n_micro=4,
                                   dp_axes=("dp",), scaler=scaler)
        return bare, opt, (lambda: step(*batch)), clip, scaler
    if wrap == "fleet":
        model = fleet.distributed_model(bare)
        opt = fleet.distributed_optimizer(adamw(model))
    else:
        model, opt, scaler = group_sharded_parallel(
            bare, adamw(bare), wrap, scaler=scaler,
            group=hcg.get_dp_sharding_parallel_group())
    step = train_step(model, None, opt, scaler=scaler, mesh=hcg.mesh,
                      step_fn=_step_fn)
    return model, opt, (lambda: step(*batch)), clip, scaler


def run_hybrid_clip(out, r, src):
    """Each ``HC_RUNS`` run for ``HC_STEPS`` fp32 steps under
    ``ClipGradByGlobalNorm(HC_CLIP)`` and ``GradScaler(HC_SCALE)``, the
    rank-``HC_POISON_RANK`` gradient poisoned at ``HC_POISON_STEP``: the
    losses, each step's global norm and this rank's own share, the
    scale, this rank's own non-finite flag, whether the poisoned step
    left every tensor it may move bit-equal, and the final parameters
    (full values on the ranks that write them)."""
    gpt_w = dict(np.load(os.path.join(src, "gpt.npz")))
    llama_w = dict(np.load(os.path.join(src, "llama.npz")))
    arrays, info = {}, {}
    for tag, (_, _, wrap) in HC_RUNS.items():
        model, opt, step, clip, scaler = _hc_build(tag, gpt_w, llama_w)
        at = {"i": 0}
        _poison_rank(scaler, r, lambda: at["i"])
        rec = dict(losses=[], norms=[], local_norms=[], scales=[],
                   local_flags=[])
        for i in range(HC_STEPS):
            at["i"] = i
            if i == HC_POISON_STEP:
                before = _state_tensors(model, opt)
            rec["losses"].append(float(step()))
            if i == HC_POISON_STEP:
                rec["skip_bit_equal"] = all(
                    torch.equal(a, b) for a, b in
                    zip(before, _state_tensors(model, opt)))
            rec["norms"].append(float(clip.last_norm))
            rec["local_norms"].append(float(clip.last_local_norm))
            rec["scales"].append(float(scaler._scale))
            rec["local_flags"].append(float(scaler._local_found_inf))
        rec["host_reads"] = scaler.host_reads
        info[tag] = rec
        if wrap == "pipeline":
            used = _used(opt, model)
            if fleet_mp_rank() == 0:
                for n, a in used.items():
                    arrays[f"{tag}/{n}"] = a
        else:
            full = model.state_dict() if wrap == "p_g_os" \
                else full_params(model)
            if r == 0:
                for n, a in full.items():
                    arrays[f"{tag}/{n}"] = np.asarray(
                        a.float().numpy() if isinstance(a, torch.Tensor)
                        else a)
        _fleet_clear()
    info["clip_by_norm_mp4"] = _clip_by_norm_mp4(llama_w)
    return arrays, info


def _clip_by_norm_mp4(llama_w):
    """``ClipGradByNorm(HC_CLIP)`` on the first step's reduced gradients
    of the LLaMA at mp 4 with SP: each parameter's whole gradient norm
    (a split one gathered over mp) before and after the clip."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel.parallel_layers \
        import mp_layers
    from paddle_tpu_torch.nn import ClipGradByNorm
    _fleet_init(mp_degree=4)
    model = fleet.distributed_model(tp_model("llama", llama_w, sp=True,
                                             llama=HC_LLAMA))
    opt = fleet.distributed_optimizer(optimizer.AdamW(
        learning_rate=LR, parameters=model.parameters()))
    ids, labels = tp_batch(HC_LLAMA["vocab_size"])
    model.train()
    _step_fn(model, torch.tensor(ids), torch.tensor(labels)).backward()
    opt._reduce_once()
    named = [(n, p) for n, p in model._layers.named_parameters()]
    clipped = ClipGradByNorm(HC_CLIP)._dygraph_clip(
        [(p, p.grad) for _, p in named])
    out = {n: (float(mp_layers.gather_parameter(p.grad, p).norm()),
               float(mp_layers.gather_parameter(g, p).norm()))
           for (n, p), (_, g) in zip(named, clipped)}
    _fleet_clear()
    return out


def fleet_mp_rank() -> int:
    from paddle_tpu_torch.distributed.fleet.base.topology import (
        get_hybrid_communicate_group)
    return get_hybrid_communicate_group().get_model_parallel_rank()


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


# ---------------------------------------------------------------------------
# distributed checkpointing
# ---------------------------------------------------------------------------

CK_STEPS = 4                     # the uninterrupted run's
CK_SAVE_AT = 2                   # the save after this many steps
# the checkpoint runs: (model, degrees, how it is wrapped); the tiny GPT
# of example 03's form (fp32 + clip + scaler) and the tiny LLaMA
CK_RUNS = {
    "gpt_os_g": ("gpt", dict(dp_degree=2, sharding_degree=2), "os_g"),
    "gpt_p_g_os": ("gpt", dict(sharding_degree=4), "p_g_os"),
    "llama_mp4": ("llama", dict(mp_degree=4), "fleet"),
    "llama_mp2_dp2": ("llama", dict(dp_degree=2, mp_degree=2), "fleet"),
}


def _ck_build(tag, gpt_w, llama_w):
    """One ``CK_RUNS`` run as example 03 writes it: the model wrapped,
    AdamW with ``ClipGradByGlobalNorm(HC_CLIP)``, ``GradScaler(HC_SCALE)``
    and ``train_step(scaler=, mesh=)``; returns ``(model, inner, opt,
    scaler, step)`` (``inner``: the model under its wrappers)."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.jit import train_step
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    kind, degrees, wrap = CK_RUNS[tag]
    hcg = _fleet_init(**degrees)
    scaler = amp.GradScaler(init_loss_scaling=HC_SCALE)
    bare = tp_model(kind, gpt_w if kind == "gpt" else llama_w,
                    llama=TP_LLAMA)
    batch = global_batch() if kind == "gpt" else \
        tp_batch(TP_LLAMA["vocab_size"])

    def adamw(m):
        return optimizer.AdamW(learning_rate=LR, parameters=m.parameters(),
                               grad_clip=ClipGradByGlobalNorm(HC_CLIP))
    if wrap == "fleet":
        model = fleet.distributed_model(bare)
        opt = fleet.distributed_optimizer(adamw(model))
    else:
        model, opt, scaler = group_sharded_parallel(
            bare, adamw(bare), wrap, scaler=scaler,
            group=hcg.get_dp_sharding_parallel_group())
    step = train_step(model, None, opt, scaler=scaler, mesh=hcg.mesh,
                      step_fn=_step_fn)
    inner = getattr(model, "_layers", model)
    return model, inner, opt, scaler, lambda: float(step(*batch))


def _ck_state(inner, opt, scaler):
    """Example 03's checkpoint dict (and its scaler's state)."""
    return {"model": inner.state_dict(), "opt": opt.state_dict(),
            "scaler": scaler.state_dict()}


def _ck_full(model, wrap):
    """Every parameter's full fp32 value, copied (a collective call)."""
    if wrap == "p_g_os":
        full = {n: v.float().numpy() for n, v in model.state_dict().items()}
    else:
        full = full_params(model)
    return {n: a.copy() for n, a in full.items()}


def _ck_moments(opt, inner):
    """The optimizer's moments by parameter name, whole (gathered over
    the shards and over mp; the torch format's index order is the
    model's parameter order; a collective call)."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel.parallel_layers \
        import mp_layers
    st = opt.state_dict()["state"]
    named = list(inner.named_parameters())
    return {f"{named[i][0]}/{k}": mp_layers.gather_parameter(
        v[k], named[i][1]).float().numpy().copy()
        for i, v in st.items() for k in ("moment1", "moment2")}


def _owned_bytes(r, inner, opt):
    """The bytes of the elements rank ``r`` owns in a save of
    ``_ck_state`` at dp 2 x sharding 2 ``os_g`` over four ranks: rank 0
    the replicated model and every parameter's two fp32 beta powers,
    each rank the fp32 moments of its shard of every bucket's parameter
    slots (the padding between slots is nobody's)."""
    n = 0
    if r == 0:
        n += sum(t.numel() * t.element_size()
                 for t in inner.state_dict().values())
        n += 2 * 4 * sum(1 for _ in inner.parameters())
    sopt = opt
    for b in sopt._reducer.buckets:
        lo, hi = sopt._shard(b)
        for p, off in zip(b.params, b.offsets):
            n += 2 * 4 * max(0, min(off + p.numel(), hi) - max(off, lo))
    return n


def run_checkpoint(out, r, src):
    """``CK_RUNS``: the tiny GPT at dp 2 x sharding 2 ``os_g`` trains
    ``CK_SAVE_AT`` steps, saves example 03's dict (``ck/gpt/2``; its
    data bytes and the bytes this rank owns), takes the optimizer's
    state dict on every rank and writes it with ``paddle_tpu_torch.save``
    on rank 0 alone (``gpt_opt.pdopt``), trains on to ``CK_STEPS``;
    a fresh model at the same layout loads and trains the same steps
    (bit-equal); one under sharding 4 ``p_g_os`` loads (its values
    against the saved full state, exactly; a load into the wrapper's
    gathered copies must leave it unchanged) and trains them; the tiny
    LLaMA at mp 4 saves (``ck/llama/2``), and one at mp 2 x dp 2 loads
    and trains them."""
    from paddle_tpu_torch.distributed import checkpoint as dck
    gpt_w = dict(np.load(os.path.join(src, "gpt.npz")))
    llama_w = dict(np.load(os.path.join(src, "llama.npz")))
    arrays, info = {}, {}
    for kind, saver, loaders in (("gpt", "gpt_os_g",
                                  ("gpt_os_g", "gpt_p_g_os")),
                                 ("llama", "llama_mp4", ("llama_mp2_dp2",))):
        path = os.path.join(out, "ck", kind)
        model, inner, opt, scaler, step = _ck_build(saver, gpt_w, llama_w)
        losses = [step() for _ in range(CK_SAVE_AT)]
        dck.save_state_dict(_ck_state(inner, opt, scaler), path,
                            unique_id=CK_SAVE_AT,
                            metadata={"step": CK_SAVE_AT})
        wrap = CK_RUNS[saver][2]
        saved = _ck_full(model, wrap)
        moments = _ck_moments(opt, inner)
        if wrap == "os_g":
            # the usual pattern: every rank takes the optimizer's state
            # dict (gathered at the call), rank 0 alone writes it
            from paddle_tpu_torch import save as psave
            opt_sd = opt.state_dict()
            if r == 0:
                psave(opt_sd, os.path.join(out, "gpt_opt.pdopt"))
        rec = info[saver] = dict(
            data_bytes=os.path.getsize(os.path.join(
                path, str(CK_SAVE_AT), f"{r}_0.distcp")))
        if wrap == "os_g":
            rec["owned_bytes"] = _owned_bytes(r, inner, opt)
        losses += [step() for _ in range(CK_STEPS - CK_SAVE_AT)]
        rec["losses"] = losses
        if wrap == "os_g":
            # the dict is the state of the call, not of a later step
            named = [n for n, _ in inner.named_parameters()]
            rec["opt_state_dict_kept"] = all(
                np.array_equal(v[k].numpy(), moments[f"{named[i]}/{k}"])
                for i, v in opt_sd["state"].items()
                for k in ("moment1", "moment2"))
            del opt_sd
        uninterrupted = _ck_full(model, wrap)
        if r == 0:
            for n, a in saved.items():
                arrays[f"{kind}_saved/{n}"] = a
            for n, a in moments.items():
                arrays[f"{kind}_saved_moments/{n}"] = a
        _fleet_clear()
        for tag in loaders:
            wrap = CK_RUNS[tag][2]
            model, inner, opt, scaler, step = _ck_build(tag, gpt_w, llama_w)
            rec = info[tag + "_load"] = {}
            if wrap == "p_g_os":
                # the control: the wrapper's state_dict is gathered
                # copies, and a load into them leaves the model as built
                built = _ck_full(model, wrap)
                copies = model.state_dict()
                dck.load_state_dict({"model": copies}, path)
                rec["copies_took_values"] = all(
                    np.array_equal(copies[n].numpy(), saved[n])
                    for n in saved)
                rec["copies_left_model"] = all(
                    np.array_equal(_ck_full(model, wrap)[n], built[n])
                    for n in built)
            state = _ck_state(inner, opt, scaler)
            dck.load_state_dict(state, path)
            scaler.set_state_dict(state["scaler"])
            loaded = _ck_full(model, wrap)
            got = _ck_moments(opt, inner)
            rec.update(
                version=dck.last_load_info()["version"],
                values_exact=all(np.array_equal(loaded[n], saved[n])
                                 for n in saved),
                values_off={n: float(np.abs(loaded[n] - saved[n]).max())
                            for n in saved
                            if not np.array_equal(loaded[n], saved[n])},
                moments_exact=sorted(got) == sorted(moments) and all(
                    np.array_equal(got[k], moments[k]) for k in moments),
                scale=float(scaler._scale))
            rec["losses"] = [step() for _ in range(CK_STEPS - CK_SAVE_AT)]
            final = _ck_full(model, wrap)
            if tag == saver:
                rec["bit_equal"] = rec["losses"] == losses[CK_SAVE_AT:] \
                    and all(np.array_equal(final[n], a)
                            for n, a in uninterrupted.items())
            if r == 0:
                for n, a in final.items():
                    arrays[f"{tag}_load/{n}"] = a
            _fleet_clear()
    return arrays, info


def run_checkpoint_crash(out, r, src):
    """The tiny GPT at dp 2 x sharding 2 ``os_g`` saves version 0
    (committed) after ``CK_SAVE_AT`` steps, trains one more and saves
    version 1 with ``ckpt_write@1=crash`` installed on rank 3 alone: rank
    3 dies between its write and the commit (the others wait in the
    commit's gather until the launcher stops them)."""
    from paddle_tpu_torch.distributed import checkpoint as dck
    from paddle_tpu_torch.resilience.faults import install_schedule
    gpt_w = dict(np.load(os.path.join(src, "gpt.npz")))
    path = os.path.join(out, "ck")
    model, inner, opt, scaler, step = _ck_build("gpt_os_g", gpt_w, None)
    for _ in range(CK_SAVE_AT):
        step()
    dck.save_state_dict(_ck_state(inner, opt, scaler), path, unique_id=0,
                        metadata={"step": CK_SAVE_AT})
    step()
    if r == 3:
        install_schedule("ckpt_write@1=crash")
    dck.save_state_dict(_ck_state(inner, opt, scaler), path, unique_id=1,
                        metadata={"step": CK_SAVE_AT + 1})
    return {}, {"survived": True}


# ---------------------------------------------------------------------------
# the semi-auto API and Engine (tests/test_torch_auto_parallel_dist.py)
# ---------------------------------------------------------------------------

# the round trips' placements on a 2 x 2 mesh ("x", "y")
# (kind, tensor dim) a mesh dim: S(hard), R(eplicate), P(artial)
AP_PLACEMENTS = {
    "s0_s1": (("S", 0), ("S", 1)), "s1_s0": (("S", 1), ("S", 0)),
    "s0_s0": (("S", 0), ("S", 0)), "r_s1": (("R", 0), ("S", 1)),
    "p_s0": (("P", 0), ("S", 0)), "p_p": (("P", 0), ("P", 0)),
    "r_r": (("R", 0), ("R", 0))}
AP_FULL = (8, 12)
AP_STEPS = 3
# tests/test_auto_parallel.py::test_semi_auto_training_parity's stack
AP_MLP = (16, 64, 4)
AP_TUNE = [(4, 1, 1), (2, 2, 1), (1, 4, 1), (2, 1, 2)]


def ap_data():
    """The semi-auto stack's global batch (16 rows)."""
    rs = np.random.RandomState(0)
    return (rs.randn(16, AP_MLP[0]).astype("float32"),
            rs.randn(16, AP_MLP[2]).astype("float32"))


def _ap_mse(out, y):
    return ((out - y) ** 2).mean()


def _ap_mlp(weights):
    from paddle_tpu_torch.nn import GELU, Linear
    m = torch.nn.Sequential(Linear(AP_MLP[0], AP_MLP[1], device="cpu"),
                            GELU(), Linear(AP_MLP[1], AP_MLP[2],
                                           device="cpu"))
    with torch.no_grad():
        for n, p in m.named_parameters():
            p.copy_(torch.from_numpy(weights[n]))
    return m


def _ap_pl(spec):
    from paddle_tpu_torch.distributed import auto_parallel as ap
    return [ap.Shard(d) if k == "S" else ap.Partial() if k == "P"
            else ap.Replicate() for k, d in spec]


def _ap_reset():
    from paddle_tpu_torch.distributed import auto_parallel as ap
    from paddle_tpu_torch.distributed.mesh import reset_mesh
    reset_mesh()
    _fleet_clear()


def _ap_roundtrips(r, arrays, info):
    """shard_tensor / reshard / unshard_dtensor on a 2 x 2 mesh and
    between it and a 1-d mesh over the same ranks; every global value
    must come back exactly."""
    from paddle_tpu_torch.distributed import auto_parallel as ap
    mesh = ap.ProcessMesh([[0, 1], [2, 3]], ["x", "y"])
    line = ap.ProcessMesh([0, 1, 2, 3], ["z"])
    full = torch.arange(np.prod(AP_FULL), dtype=torch.float32).reshape(
        AP_FULL) - 40.0
    exact = True
    for tag, spec in AP_PLACEMENTS.items():
        pl = _ap_pl(spec)
        t = ap.shard_tensor(full.clone(), mesh, pl)
        arrays[f"rt/{tag}"] = t.numpy()
        exact &= torch.equal(ap.unshard_dtensor(t), full)
        exact &= ap.global_shape(t) == list(AP_FULL)
        for tag2, spec2 in AP_PLACEMENTS.items():
            r2 = ap.reshard(t, mesh, _ap_pl(spec2))
            exact &= torch.equal(ap.unshard_dtensor(r2), full)
            if tag == "s0_s1":
                arrays[f"rt/{tag}->{tag2}"] = r2.numpy()
        across = ap.reshard(t, line, [ap.Shard(0)])
        arrays[f"rt/{tag}->line"] = across.numpy()
        back = ap.reshard(across, mesh, pl)
        exact &= torch.equal(back, t)
    info["roundtrips_exact"] = bool(exact)
    try:
        ap.shard_tensor(torch.zeros(6, 5), mesh, [ap.Replicate(),
                                                   ap.Shard(1)])
        info["odd_split"] = None
    except ValueError as e:
        info["odd_split"] = str(e)


def _ap_semi_auto(r, weights, arrays, info):
    """The Linear-GELU-Linear stack: semi-auto at dp 2 x mp 2 (bias
    Shard(0), and replicated), through train_step and through Engine.fit,
    and the plain stack at dp 4."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import auto_parallel as ap
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.jit import train_step
    x, y = ap_data()

    def semi(bias_split):
        _ap_reset()
        mesh = ap.ProcessMesh([[0, 1], [2, 3]], ["dp", "mp"])
        ap.set_mesh(mesh)
        m = _ap_mlp(weights)
        ap.shard_tensor(m[0].weight, mesh, [ap.Replicate(), ap.Shard(1)])
        if bias_split:
            ap.shard_tensor(m[0].bias, mesh, [ap.Replicate(), ap.Shard(0)])
        ap.shard_tensor(m[2].weight, mesh, [ap.Replicate(), ap.Shard(0)])
        o = ap.shard_optimizer(optimizer.AdamW(
            learning_rate=LR, parameters=m.parameters()))
        return m, o, mesh
    m, o, mesh = semi(True)
    info["mp_param_numel"] = sum(p.numel() for p in m.parameters())
    step = train_step(m, _ap_mse, o, mesh=mesh.rank_mesh)
    info["semi"] = [float(step(x, y)) for _ in range(AP_STEPS)]
    for n, p in m.named_parameters():
        arrays[f"semi/{n}"] = ap.unshard_dtensor(p).detach().numpy()
        arrays[f"semi_local/{n}"] = p.detach().numpy()
    m, o, mesh = semi(False)
    step = train_step(m, _ap_mse, o, mesh=mesh.rank_mesh)
    info["semi_bias_replicated"] = [float(step(x, y))
                                    for _ in range(AP_STEPS)]
    m, o, mesh = semi(True)

    class DS:
        def __len__(self):
            return AP_STEPS

        def __getitem__(self, i):
            return x, y
    eng = ap.Engine(m, loss=_ap_mse, optimizer=o)
    info["semi_engine"] = eng.fit(DS(), batch_size=None)["loss"]
    info["semi_engine_eval"] = eng.evaluate(DS(), batch_size=None,
                                            steps=1)["eval_loss"]
    _ap_reset()
    m = _ap_mlp(weights)
    o = optimizer.AdamW(learning_rate=LR, parameters=m.parameters())
    step = train_step(m, _ap_mse, o, mesh=build_mesh({"dp": N_RANKS}))
    info["dp4"] = [float(step(x, y)) for _ in range(AP_STEPS)]
    info["dp4_param_numel"] = sum(p.numel() for p in m.parameters())
    for n, p in m.named_parameters():
        arrays[f"dp4/{n}"] = p.detach().numpy()
    _ap_reset()
    m = _ap_mlp(weights)
    eng = ap.Engine(m, loss=_ap_mse, optimizer=optimizer.AdamW(
        learning_rate=LR, parameters=m.parameters()))
    ap.set_mesh(ap.ProcessMesh([0, 1, 2, 3], ["dp"]))
    info["dp4_engine"] = eng.fit(DS(), batch_size=None)["loss"]
    info["dp4_engine_eval"] = eng.evaluate(DS(), batch_size=None,
                                           steps=1)["eval_loss"]
    out = eng.predict(DS(), batch_size=None, steps=1)[0]
    arrays["dp4_predict"] = out.numpy()
    arrays["dp4_forward"] = m(torch.from_numpy(x)).detach().numpy()


def _ap_refusals(info):
    """Placements outside the rule table raise at 4 ranks."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import auto_parallel as ap
    from paddle_tpu_torch.jit import train_step
    from paddle_tpu_torch.nn import Linear
    _ap_reset()
    got = {}
    for tag, names, pl in (
            ("data_dim", ["dp", "mp"], [ap.Shard(1), ap.Replicate()]),
            ("two_dims", ["x", "mp"], [ap.Shard(0), ap.Shard(1)]),
            ("partial", ["dp", "mp"], [ap.Replicate(), ap.Partial()])):
        mesh = ap.ProcessMesh([[0, 1], [2, 3]], names)
        m = torch.nn.Sequential(Linear(4, 8, device="cpu"))
        ap.shard_tensor(m[0].weight, mesh, pl)
        try:
            train_step(m, _ap_mse, optimizer.SGD(
                parameters=m.parameters()), mesh=mesh.rank_mesh)
            got[tag] = None
        except NotImplementedError as e:
            got[tag] = str(e)
    info["refusals"] = got


def _ap_moe(weights, info):
    """The tiny ERNIE-MoE through Engine.fit at dp 2 x ep 2, and the same
    steps through train_step."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import auto_parallel as ap
    from paddle_tpu_torch.incubate.distributed.models.moe import (
        ClipGradForMOEByGlobalNorm)
    batch = moe_batch(256)

    class DS:
        def __len__(self):
            return STEPS

        def __getitem__(self, i):
            return batch
    _ap_reset()
    hcg = _fleet_init(**MOE_RUNS["dp2_ep2"])
    model = _moe_model(weights)
    opt = optimizer.AdamW(learning_rate=LR, parameters=model.parameters(),
                          weight_decay=0.01,
                          grad_clip=ClipGradForMOEByGlobalNorm(MOE_CLIP))
    eng = ap.Engine(model, loss=model.loss_fn, optimizer=opt)
    info["moe_engine"] = eng.fit(DS(), batch_size=None)["loss"]
    info["moe_engine_cost"] = list(eng.cost())
    _ap_reset()
    hcg = _fleet_init(**MOE_RUNS["dp2_ep2"])
    _, info["moe_step"] = _moe_train("dp2_ep2", hcg, weights, batch)
    _ap_reset()


def _ap_tune(info, arrays):
    """Engine.tune on 4 ranks: the card's defaults (``_card_backend``
    patched), every trial leaving the parameters bit-equal and no
    reducer behind, the mp candidates of a plain model running."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import auto_parallel as ap
    from paddle_tpu_torch.distributed.auto_parallel import engine as eng_mod
    from paddle_tpu_torch.distributed.parallel import reducer_of
    from paddle_tpu_torch.io import TensorDataset
    from paddle_tpu_torch.nn import Linear
    eng_mod._card_backend = lambda: True
    rs = np.random.RandomState(0)
    x = rs.randn(8, 16).astype(np.float32)
    y = rs.randn(8, 8).astype(np.float32)

    def engine():
        _ap_reset()
        torch.manual_seed(0)
        m = torch.nn.Sequential(Linear(16, 32, device="cpu"),
                                torch.nn.ReLU(), Linear(32, 8, device="cpu"))
        o = optimizer.SGD(learning_rate=0.1, parameters=m.parameters())
        return m, ap.Engine(m, loss=_ap_mse, optimizer=o)
    m, eng = engine()
    before = [p.detach().clone() for p in m.parameters()]
    got = eng.tune(x, y, candidates=AP_TUNE)
    info["tune_explicit"] = eng.tuning_report
    info["tune_winner"] = [got["dp"], got["sharding"], got["mp"]]
    info["tune_bit_equal"] = all(torch.equal(a, b) for a, b in
                                 zip(before, m.parameters()))
    info["tune_reducers_left"] = sum(reducer_of(p) is not None
                                     for p in m.parameters())
    info["tune_hooks_left"] = sum(len(getattr(p, "_post_accumulate_grad_"
                                              "hooks", None) or {})
                                  for p in m.parameters())
    ds = TensorDataset([torch.from_numpy(x), torch.from_numpy(y)])
    info["tune_fit"] = eng.fit(ds, batch_size=8)["loss"]
    m, eng = engine()
    eng.tune(x, y, budget_s=600.0)
    info["tune_auto"] = eng.tuning_report
    m, eng = engine()
    eng.tune(x, y, candidates=AP_TUNE, profile=True, top_k=2)
    info["tune_top_k"] = eng.tuning_report
    m, eng = engine()
    eng.tune(x, y, candidates=AP_TUNE, budget_s=0.0)
    info["tune_budget"] = eng.tuning_report
    _ap_reset()


def run_auto_parallel(out, r, src):
    arrays, info = {}, {}
    _ap_roundtrips(r, arrays, info)
    _ap_semi_auto(r, dict(np.load(os.path.join(src, "mlp.npz"))), arrays,
                  info)
    _ap_refusals(info)
    _ap_moe(dict(np.load(os.path.join(src, "ernie.npz"))), info)
    _ap_tune(info, arrays)
    return arrays, info


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
    elif mode == "tensor_parallel":
        arrays, info = run_tensor_parallel(
            out, r, dict(np.load(sys.argv[3])), dict(np.load(sys.argv[4])),
            dict(np.load(sys.argv[5])))
    elif mode == "segment_parallel":
        arrays, info = run_segment_parallel(out, r, sys.argv[3])
    elif mode == "pipeline":
        arrays, info = run_pipeline(out, r, sys.argv[3])
    elif mode == "moe":
        arrays, info = run_moe(out, r, sys.argv[3])
    elif mode == "hybrid_clip":
        arrays, info = run_hybrid_clip(out, r, sys.argv[3])
    elif mode == "checkpoint":
        arrays, info = run_checkpoint(out, r, sys.argv[3])
    elif mode == "checkpoint_crash":
        arrays, info = run_checkpoint_crash(out, r, sys.argv[3])
    elif mode == "auto_parallel":
        arrays, info = run_auto_parallel(out, r, sys.argv[3])
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
