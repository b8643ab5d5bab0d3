"""Signatures of the port's public entry points outside ``nn.functional``
against the JAX package's: each takes the reference's parameters, in its
order, with its defaults and kinds (read with ``inspect.signature``);
only a keyword-only ``generator`` or ``device`` may follow them.  Then
what each repaired parameter does: where the port honours it, the same
as the reference (``embedding``'s ``padding_idx``, ``submit``'s
``request_id``, ``trace`` and ``deadline_s``, the engine's and the
scheduler's fault-containment and admission parameters, ``decorate``'s
``excluded_layers``, the attention's ``training``, ``stop``'s result);
where it does not, a value other than the default raises
``NotImplementedError``.
"""
import importlib
import inspect

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.inference import serving as jhttp
from paddle_tpu.models import generation as jgen
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.nn import functional as jF
from paddle_tpu.optimizer import optimizer as jopt_base
from paddle_tpu.optimizer import optimizers as jopt
from paddle_tpu.serving import engine as jengine
from paddle_tpu.serving import scheduler as jsched
from paddle_tpu.serving.fleet import perf_merge as jmerge
from paddle_tpu.serving.fleet import replica as jreplica
from paddle_tpu.serving.fleet import router as jrouter
from paddle_tpu.tuning import cache as jcache

from paddle_tpu_torch import amp, optimizer
from paddle_tpu_torch.flags import set_flags
from paddle_tpu_torch.inference import serving as thttp
from paddle_tpu_torch.models import GPTForPretraining, gpt_config
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.nn import functional as tF
from paddle_tpu_torch.observability import tracing as ttracing
from paddle_tpu_torch.optimizer import optimizer as topt_base
from paddle_tpu_torch.optimizer import optimizers as topt
from paddle_tpu_torch.resilience import driver as tdriver
from paddle_tpu_torch.serving import engine as tengine
from paddle_tpu_torch.serving import scheduler as tsched
from paddle_tpu_torch.serving.fleet import perf_merge as tmerge
from paddle_tpu_torch.serving.fleet import replica as treplica
from paddle_tpu_torch.serving.fleet import router as trouter
from paddle_tpu_torch.tuning import cache as tcache

import paddle_tpu.distributed as jdist
from paddle_tpu.distributed import sharding as jsharding
from paddle_tpu.distributed.communication import store as jstore
from paddle_tpu.distributed.fleet.meta_optimizers.dygraph_optimizer import (
    hybrid_parallel_optimizer as jhpo)
from paddle_tpu.distributed.fleet.utils import hybrid_parallel_util as jhpu
from paddle_tpu.distributed.launch import launch as jlaunch
from paddle_tpu.distributed.fleet.meta_parallel.sharding import (
    group_sharded as jgs)
from paddle_tpu.distributed.passes import gradient_merge as jgm
from paddle_tpu.incubate.nn import functional as jinc
from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu.distributed.fleet.meta_parallel import (
    segment_parallel as jseg, tensor_parallel as jtp)
from paddle_tpu.distributed.fleet.meta_parallel.parallel_layers import (
    mp_layers as jmp, random as jrandom)
from paddle_tpu.distributed.fleet.utils import (
    sequence_parallel_utils as jspu)
from paddle_tpu.ops import ring_attention as jring, ulysses as julysses
from paddle_tpu import random_state as jrandom_state
from paddle_tpu.distributed.fleet.meta_parallel import (
    pipeline_parallel as jpp, pp_schedules as jpps, pp_spmd as jppspmd)
from paddle_tpu.distributed.fleet.meta_parallel.parallel_layers import (
    pp_layers as jppl)
from paddle_tpu.models import llama as jllama
from paddle_tpu.incubate.distributed.models.moe import moe_layer as jmoe
from paddle_tpu.models import ernie_moe as jernie
from paddle_tpu.nn import clip as jclip
from paddle_tpu.distributed import utils as jdutils

import paddle_tpu_torch.distributed as tdist
from paddle_tpu_torch.distributed import sharding as tsharding
from paddle_tpu_torch.distributed.communication import store as tstore
from paddle_tpu_torch.distributed.fleet.meta_optimizers.dygraph_optimizer import (
    hybrid_parallel_optimizer as thpo)
from paddle_tpu_torch.distributed.fleet.utils import hybrid_parallel_util as thpu
from paddle_tpu_torch.distributed.launch import launch as tlaunch
from paddle_tpu_torch.distributed.mesh import build_mesh as tbuild_mesh
from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding import (
    group_sharded as tgs)
from paddle_tpu_torch.distributed.passes import gradient_merge as tgm
from paddle_tpu_torch.incubate.nn import functional as tinc
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    segment_parallel as tseg, tensor_parallel as ttp)
from paddle_tpu_torch.distributed.fleet.meta_parallel.parallel_layers import (
    mp_layers as tmp, random as trandom)
from paddle_tpu_torch.distributed.fleet.utils import (
    sequence_parallel_utils as tspu)
from paddle_tpu_torch.ops import ring_attention as tring, ulysses as tulysses
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    pipeline_parallel as tpp, pp_schedules as tpps, pp_spmd as tppspmd)
from paddle_tpu_torch.distributed.fleet.meta_parallel.parallel_layers import (
    pp_layers as tppl)
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.incubate.distributed.models.moe import (
    moe_layer as tmoe)
from paddle_tpu_torch.models import ernie_moe as ternie
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import clip as tclip
from paddle_tpu_torch.nn import initializer as tinit
from paddle_tpu_torch.distributed import utils as tdutils

# the modules (each package's ``jit`` exports the function of that name,
# each ``fleet`` package the singleton named as its module)
jtrain = importlib.import_module("paddle_tpu.jit.train_step")
jfleet_mod = importlib.import_module("paddle_tpu.distributed.fleet.fleet")
# each package's ``fleet.recompute`` names the function, not its module
jrc = importlib.import_module(
    "paddle_tpu.distributed.fleet.recompute.recompute")
trc = importlib.import_module(
    "paddle_tpu_torch.distributed.fleet.recompute.recompute")
tfleet_mod = importlib.import_module(
    "paddle_tpu_torch.distributed.fleet.fleet")
jdriver = importlib.import_module("paddle_tpu.resilience.driver")
ttrain = importlib.import_module("paddle_tpu_torch.jit.train_step")

# name: (the reference, the port)
PAIRS = {
    "ServingEngine.__init__": (jengine.ServingEngine.__init__,
                               tengine.ServingEngine.__init__),
    "ServingEngine.stop": (jengine.ServingEngine.stop,
                           tengine.ServingEngine.stop),
    "ServingEngine.submit": (jengine.ServingEngine.submit,
                             tengine.ServingEngine.submit),
    "Request.__init__": (jsched.Request.__init__, tsched.Request.__init__),
    "Scheduler.__init__": (jsched.Scheduler.__init__,
                           tsched.Scheduler.__init__),
    "Scheduler.window_budget": (jsched.Scheduler.window_budget,
                                tsched.Scheduler.window_budget),
    "Scheduler.commit_window": (jsched.Scheduler.commit_window,
                                tsched.Scheduler.commit_window),
    "Scheduler.prestage_plan": (jsched.Scheduler.prestage_plan,
                                tsched.Scheduler.prestage_plan),
    "build_fused_window_step": (jgen.build_fused_window_step,
                                tgen.build_fused_window_step),
    "InferenceServer.__init__": (jhttp.InferenceServer.__init__,
                                 thttp.InferenceServer.__init__),
    "generate_http": (jhttp.generate_http, thttp.generate_http),
    "embedding": (jF.embedding, tF.embedding),
    "auto_cast": (jamp.auto_cast, amp.auto_cast),
    "decorate": (jamp.decorate, amp.decorate),
    "Optimizer.__init__": (jopt_base.Optimizer.__init__,
                           topt_base.Optimizer.__init__),
    "Optimizer.clear_grad": (jopt_base.Optimizer.clear_grad,
                             topt_base.Optimizer.clear_grad),
    "SGD.__init__": (jopt.SGD.__init__, topt.SGD.__init__),
    "Adam.__init__": (jopt.Adam.__init__, topt.Adam.__init__),
    "AdamW.__init__": (jopt.AdamW.__init__, topt.AdamW.__init__),
    "GradScaler.__init__": (jamp.GradScaler.__init__,
                            amp.GradScaler.__init__),
    **{f"GradScaler.{m}": (getattr(jamp.GradScaler, m),
                           getattr(amp.GradScaler, m))
       for m in ("scale", "unscale_", "step", "update", "minimize",
                 "is_enable", "is_use_dynamic_loss_scaling",
                 "get_init_loss_scaling", "set_init_loss_scaling",
                 "state_dict", "set_state_dict")},
    "TrainStep.__init__": (jtrain.TrainStep.__init__,
                           ttrain.TrainStep.__init__),
    "train_step": (jtrain.train_step, ttrain.train_step),
    "MultiHeadAttention.forward": (jgpt.MultiHeadAttention.forward,
                                   tgpt.MultiHeadAttention.forward),
    "generate": (jgen.generate, tgen.generate),
    "FleetRouter.__init__": (jrouter.FleetRouter.__init__,
                             trouter.FleetRouter.__init__),
    "ReplicaSupervisor.__init__": (jreplica.ReplicaSupervisor.__init__,
                                   treplica.ReplicaSupervisor.__init__),
    "ReplicaSupervisor.rolling_restart": (
        jreplica.ReplicaSupervisor.rolling_restart,
        treplica.ReplicaSupervisor.rolling_restart),
    "ReplicaSupervisor.restart_replica": (
        jreplica.ReplicaSupervisor.restart_replica,
        treplica.ReplicaSupervisor.restart_replica),
    "merge_models": (jmerge.merge_models, tmerge.merge_models),
    "restart_backoff": (jdriver.restart_backoff, tdriver.restart_backoff),
    "TuningCache.__init__": (jcache.TuningCache.__init__,
                             tcache.TuningCache.__init__),
    "TuningCache.prune": (jcache.TuningCache.prune, tcache.TuningCache.prune),
    "flash_attention_bhsd": (jfa.flash_attention_bhsd,
                             tfa.flash_attention_bhsd),
    "fused_rms_norm": (jinc.fused_rms_norm, tinc.fused_rms_norm),
    "init_parallel_env": (jdist.init_parallel_env, tdist.init_parallel_env),
    "DataParallel.__init__": (jdist.DataParallel.__init__,
                              tdist.DataParallel.__init__),
    "spawn": (jdist.spawn, tdist.spawn),
    "get_rank": (jdist.get_rank, tdist.get_rank),
    "get_world_size": (jdist.get_world_size, tdist.get_world_size),
    "new_group": (jdist.new_group, tdist.new_group),
    "TCPStore.__init__": (jstore.TCPStore.__init__, tstore.TCPStore.__init__),
    "TCPStore.get": (jstore.TCPStore.get, tstore.TCPStore.get),
    "TCPStore.set": (jstore.TCPStore.set, tstore.TCPStore.set),
    "TCPStore.add": (jstore.TCPStore.add, tstore.TCPStore.add),
    "TCPStore.wait": (jstore.TCPStore.wait, tstore.TCPStore.wait),
    "TCPStore.delete_key": (jstore.TCPStore.delete_key,
                            tstore.TCPStore.delete_key),
    "P2POp.__init__": (jdist.P2POp.__init__, tdist.P2POp.__init__),
    **{op: (getattr(jdist, op), getattr(tdist, op)) for op in (
        "all_reduce", "reduce", "all_gather", "gather", "all_gather_object",
        "broadcast", "broadcast_object_list", "scatter",
        "scatter_object_list", "reduce_scatter", "alltoall",
        "alltoall_single", "send", "recv", "isend", "irecv",
        "batch_isend_irecv", "barrier", "wait")},
    "fleet.init": (jfleet_mod.Fleet.init, tfleet_mod.Fleet.init),
    "fleet.distributed_model": (jfleet_mod.Fleet.distributed_model,
                                tfleet_mod.Fleet.distributed_model),
    "fleet.distributed_optimizer": (jfleet_mod.Fleet.distributed_optimizer,
                                    tfleet_mod.Fleet.distributed_optimizer),
    "HybridParallelOptimizer.__init__": (
        jhpo.HybridParallelOptimizer.__init__,
        thpo.HybridParallelOptimizer.__init__),
    "DygraphShardingOptimizer.__init__": (
        jhpo.DygraphShardingOptimizer.__init__,
        thpo.DygraphShardingOptimizer.__init__),
    "fused_allreduce_gradients": (jhpu.fused_allreduce_gradients,
                                  thpu.fused_allreduce_gradients),
    "broadcast_dp_parameters": (jhpu.broadcast_dp_parameters,
                                thpu.broadcast_dp_parameters),
    "group_sharded_parallel": (jsharding.group_sharded_parallel,
                               tsharding.group_sharded_parallel),
    "save_group_sharded_model": (jsharding.save_group_sharded_model,
                                 tsharding.save_group_sharded_model),
    "GradientMergeOptimizer.__init__": (jgm.GradientMergeOptimizer.__init__,
                                        tgm.GradientMergeOptimizer.__init__),
    "recompute": (jrc.recompute, trc.recompute),
    "recompute_sequential": (jrc.recompute_sequential,
                             trc.recompute_sequential),
    "recompute_hybrid": (jrc.recompute_hybrid, trc.recompute_hybrid),
    "launch": (jlaunch, tlaunch),
    **{f"{cls}.__init__": (getattr(jmp, cls).__init__,
                           getattr(tmp, cls).__init__)
       for cls in ("VocabParallelEmbedding", "ColumnParallelLinear",
                   "RowParallelLinear", "ParallelCrossEntropy")},
    **{f"{cls}.__init__": (getattr(jspu, cls).__init__,
                           getattr(tspu, cls).__init__)
       for cls in ("ColumnSequenceParallelLinear",
                   "RowSequenceParallelLinear")},
    **{fn: (getattr(jspu, fn), getattr(tspu, fn))
       for fn in ("mark_as_sequence_parallel_parameter",
                  "is_sequence_parallel_parameter",
                  "register_sequence_parallel_allreduce_hooks")},
    "TensorParallel.__init__": (jtp.TensorParallel.__init__,
                                ttp.TensorParallel.__init__),
    "model_parallel_random_seed": (jrandom.model_parallel_random_seed,
                                   trandom.model_parallel_random_seed),
    "determinate_seed": (jrandom.determinate_seed, trandom.determinate_seed),
    "RNGStatesTracker.add": (jrandom_state.RNGStatesTracker.add,
                             trandom.RNGStatesTracker.add),
    "RNGStatesTracker.rng_state": (jrandom_state.RNGStatesTracker.rng_state,
                                   trandom.RNGStatesTracker.rng_state),
    "broadcast_mp_parameters": (jhpu.broadcast_mp_parameters,
                                thpu.broadcast_mp_parameters),
    "broadcast_sep_parameters": (jhpu.broadcast_sep_parameters,
                                 thpu.broadcast_sep_parameters),
    "ring_attention_bhsd": (jring.ring_attention_bhsd,
                            tring.ring_attention_bhsd),
    "ulysses_attention": (julysses.ulysses_attention,
                          tulysses.ulysses_attention),
    **{fn: (getattr(jseg, fn), getattr(tseg, fn))
       for fn in ("active_seq_parallel_axis", "sep_attention",
                  "cp_ring_attention", "segment_parallel_attention")},
    **{f"{cls}.__init__": (getattr(jppl, cls).__init__,
                           getattr(tppl, cls).__init__)
       for cls in ("LayerDesc", "SharedLayerDesc", "SegmentLayers",
                   "PipelineLayer")},
    **{f"PipelineParallel.{m}": (getattr(jpp.PipelineParallel, m),
                                 getattr(tpp.PipelineParallel, m))
       for m in ("__init__", "train_batch", "eval_batch",
                 "forward_backward_pipeline")},
    **{f"HostPipelineSchedule.{m}": (getattr(jpps.HostPipelineSchedule, m),
                                     getattr(tpps.HostPipelineSchedule, m))
       for m in ("__init__", "forward_backward")},
    "PipelineSpmdStep.__init__": (jppspmd.PipelineSpmdStep.__init__,
                                  tppspmd.PipelineSpmdStep.__init__),
    "make_transformer_pipeline_step": (
        jppspmd.make_transformer_pipeline_step,
        tppspmd.make_transformer_pipeline_step),
    "gpt_pipeline_step": (jppspmd.gpt_pipeline_step,
                          tppspmd.gpt_pipeline_step),
    "llama_pipeline_step": (jllama.llama_pipeline_step,
                            tllama.llama_pipeline_step),
    **{f"{cls}.__init__": (getattr(jmoe, cls).__init__,
                           getattr(tmoe, cls).__init__)
       for cls in ("MoELayer", "NaiveGate", "GShardGate", "SwitchGate",
                   "ClipGradForMOEByGlobalNorm")},
    "ClipGradByGlobalNorm.__init__": (jclip.ClipGradByGlobalNorm.__init__,
                                      tclip.ClipGradByGlobalNorm.__init__),
    "ClipGradByValue.__init__": (jclip.ClipGradByValue.__init__,
                                 tclip.ClipGradByValue.__init__),
    "ClipGradByNorm.__init__": (jclip.ClipGradByNorm.__init__,
                                tclip.ClipGradByNorm.__init__),
    "clip_grad_norm_": (jclip.clip_grad_norm_, tclip.clip_grad_norm_),
    "clip_grad_value_": (jclip.clip_grad_value_, tclip.clip_grad_value_),
    "ErnieMoEConfig.__init__": (jernie.ErnieMoEConfig.__init__,
                                ternie.ErnieMoEConfig.__init__),
    **{fn: (getattr(jdutils, fn), getattr(tdutils, fn))
       for fn in ("global_scatter", "global_gather", "expert_count")},
}
EXTRA = {"generator", "device"}


def _params(fn):
    return [(p.name, p.kind, p.default)
            for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("name", list(PAIRS))
def test_signature_matches_reference(name):
    ref, port = PAIRS[name]
    extra = [p for p in _params(port) if p not in _params(ref)]
    assert all(kind is inspect.Parameter.KEYWORD_ONLY and pname in EXTRA
               for pname, kind, _ in extra), extra
    assert [p for p in _params(port) if p not in extra] == _params(ref)


def test_ernie_moe_config_fields_match_reference():
    """``ErnieMoEConfig``'s fields, their order and defaults, and what
    ``__post_init__`` fills in; the presets the same."""
    import dataclasses
    assert [(f.name, f.default) for f in
            dataclasses.fields(ternie.ErnieMoEConfig)] == \
        [(f.name, f.default) for f in
         dataclasses.fields(jernie.ErnieMoEConfig)]
    assert dataclasses.asdict(ternie.ErnieMoEConfig()) == \
        dataclasses.asdict(jernie.ErnieMoEConfig())
    assert ternie.ERNIE_MOE_PRESETS == jernie.ERNIE_MOE_PRESETS


def test_group_sharded_stage3_signature_matches_reference():
    """``GroupShardedStage3.__init__`` takes the reference's parameters in
    its order, with its defaults but ``device``'s: the reference's
    ``"tpu"`` names its own card, the port's ``"gpu"`` the CUDA card
    (upstream Paddle's default)."""
    ref = _params(jgs.GroupShardedStage3.__init__)
    port = _params(tgs.GroupShardedStage3.__init__)
    assert [(n, k) for n, k, _ in port] == [(n, k) for n, k, _ in ref]
    assert [d for n, _, d in port if n != "device"] == \
        [d for n, _, d in ref if n != "device"]
    assert dict((n, d) for n, _, d in port)["device"] == "gpu"


# ---------------------------------------------------------------------------
# parameters the port does not support raise
# ---------------------------------------------------------------------------

def _param():
    return [torch.nn.Parameter(torch.zeros(3))]


def _tiny_gpt():
    return GPTForPretraining(gpt_config(
        "tiny", hidden_dropout_prob=0.0, attention_dropout_prob=0.0),
        device="cpu")


UNSUPPORTED = {
    "InferenceServer predictor": lambda: thttp.InferenceServer(
        predictor=object(), engine=object()),
    "auto_cast custom_white_list": lambda: amp.auto_cast(
        custom_white_list=["matmul"]).__enter__(),
    "auto_cast custom_black_list": lambda: amp.auto_cast(
        custom_black_list=["matmul"]).__enter__(),
    "auto_cast use_promote": lambda: amp.auto_cast(
        use_promote=False).__enter__(),
    "decorate save_dtype": lambda: amp.decorate(
        torch.nn.Linear(2, 2), save_dtype="float32"),
    "decorate master_grad": lambda: amp.decorate(
        torch.nn.Linear(2, 2), master_grad=True),
    "adam lazy_mode": lambda: optimizer.Adam(parameters=_param(),
                                             lazy_mode=True),
    "adam use_multi_tensor": lambda: optimizer.Adam(
        parameters=_param(), use_multi_tensor=True),
    "adamw lazy_mode": lambda: optimizer.AdamW(parameters=_param(),
                                               lazy_mode=True),
    # a mesh's pipeline axis (pipelines train through PipelineParallel
    # and the pipeline steps: tests/test_torch_pipeline_parallel.py) and a
    # batch_spec sharding a dimension other than the batch (model, sep
    # and cp axes run: tests/test_torch_tensor_parallel.py)
    "train_step mesh": lambda: ttrain.train_step(
        torch.nn.Linear(2, 2), lambda y: y.sum(),
        mesh=tbuild_mesh({"dp": 1, "pp": 2}, devices=[0, 1])),
    "TrainStep batch_spec": lambda: ttrain.TrainStep(
        torch.nn.Linear(2, 2), lambda y: y.sum(),
        mesh=tbuild_mesh({"dp": 1}, devices=[0]), batch_spec=[None, "dp"]),
    "flash_attention_bhsd block sizes": lambda: tfa.flash_attention_bhsd(
        *[torch.zeros(1, 4, 8)] * 3, 1.0, True, 64, 64),
    "fused_rms_norm residual": lambda: tinc.fused_rms_norm(
        torch.ones(2, 4), torch.ones(4), residual=torch.ones(2, 4)),
    # stage 3 runs; the reference's options it does not have still raise
    "group_sharded_parallel p_g_os offload": lambda:
        tsharding.group_sharded_parallel(None, None, "p_g_os", offload=True),
    "group_sharded_parallel p_g_os sync_comm": lambda:
        tsharding.group_sharded_parallel(None, None, "p_g_os",
                                         sync_comm=True),
    "group_sharded_parallel p_g_os exclude_layer": lambda:
        tsharding.group_sharded_parallel(None, None, "p_g_os",
                                         exclude_layer=["Linear"]),
    "GroupShardedStage3 segment_size": lambda: tsharding.GroupShardedStage3(
        None, segment_size=2 ** 10),
    "launch elastic_timeout": lambda: tlaunch(
        "script.py", elastic_timeout=30.0, device="cpu"),
    "launch nnodes": lambda: tlaunch("script.py", nnodes=2, device="cpu"),
    "scatter without tensor_list": lambda: tdist.scatter(torch.zeros(2)),
    "sgd weight_decay": lambda: optimizer.SGD(parameters=_param(),
                                              weight_decay=0.01),
    "HostPipelineSchedule dp_degree": lambda: tpps.HostPipelineSchedule(
        None, dp_degree=2),
    "generate unknown keyword": lambda: tgen.generate(
        _tiny_gpt(), np.zeros((1, 4), np.int64), max_new_tokens=1,
        attention_mask=None),
}


@pytest.mark.parametrize("case", list(UNSUPPORTED))
def test_unsupported_parameter_raises(case):
    with pytest.raises(NotImplementedError):
        UNSUPPORTED[case]()


class _BatchStepModel:
    """A learned-perf-model stand-in with a ``batch_step`` head."""

    def has(self, family):
        return family == "batch_step"

    def predict(self, family, feats):
        return 0.01


def _engine(**kw):
    return tengine.ServingEngine(_tiny_gpt(), max_batch=2, page_size=8,
                                 device="cpu", **kw)


def _scheduler(mod, **kw):
    return mod.Scheduler(mod.PagePool(8, 4), 2, 2, **kw)


# the parameters this port took and raised on until its fault-containment
# slice: each is now honoured as in the reference
HONOURED = {
    "engine perf_model": lambda: _engine(
        perf_model=_BatchStepModel(),
        max_step_cost_s=0.5).scheduler.perf_model.__class__.__name__
    == "_BatchStepModel",
    "engine max_step_cost_s": lambda: (
        lambda e: (e.scheduler.max_step_cost_s, e.scheduler.perf_model))(
        _engine(max_step_cost_s=0.5)) == (0.5, None),
    "engine health_recovery_steps": lambda: _engine(
        health_recovery_steps=8).health_recovery_steps == 8,
    "engine max_watchdog_relaunches": lambda: _engine(
        max_watchdog_relaunches=1).max_watchdog_relaunches == 1,
    "request deadline_s": lambda: all(
        (r.deadline_s, round(r.deadline_at - r.submitted_at, 6)) == (1.0, 1.0)
        for r in (jsched.Request([1, 2], deadline_s=1.0),
                  tsched.Request([1, 2], deadline_s=1.0))),
    "scheduler perf_model": lambda: all(
        isinstance(_scheduler(m, perf_model=_BatchStepModel()).perf_model,
                   _BatchStepModel) for m in (jsched, tsched)),
    "scheduler max_step_cost_s": lambda: all(
        _scheduler(m, max_step_cost_s=0.5).max_step_cost_s == 0.5
        for m in (jsched, tsched)),
    # the broadcasts run (tests/test_torch_tensor_parallel.py holds them
    # on 4 ranks); in a world of one they leave the weights as they are
    "broadcast_mp_parameters": lambda: _broadcast_keeps_one_rank(
        thpu.broadcast_mp_parameters),
    "broadcast_sep_parameters": lambda: _broadcast_keeps_one_rank(
        thpu.broadcast_sep_parameters),
    # amp.GradScaler runs (tests/test_torch_grad_scaler.py holds it against
    # the JAX scaler, tests/test_torch_hybrid_clip.py the pipeline steps'
    # use of it on 4 ranks); the pipeline step keeps an enabled one
    "PipelineSpmdStep scaler": lambda: _spmd_scaler_kept(),
    "ParamAttr need_clip": lambda: getattr(tnn.Linear(
        2, 2, weight_attr=tinit.ParamAttr(need_clip=False),
        device="cpu").weight, "need_clip", True) is False,
}


def _spmd_scaler_kept() -> bool:
    """``PipelineSpmdStep`` stores an enabled scaler (and drops a
    disabled one, as the JAX step does) before it reads the topology."""
    kept = {}

    class Probe(tppspmd.PipelineSpmdStep):
        def __init__(self, scaler):
            try:
                super().__init__(None, None, None, [], [], None, None, 1,
                                 scaler=scaler)
            except ValueError:          # no fleet topology here
                kept[scaler.is_enable()] = getattr(self, "scaler", "unset")
    on, off = amp.GradScaler(), amp.GradScaler(enable=False)
    Probe(on)
    Probe(off)
    return kept == {True: on, False: None}


def _broadcast_keeps_one_rank(fn) -> bool:
    tdist.init_parallel_env(device="cpu")
    try:
        model = _tiny_gpt()
        before = [p.detach().clone() for p in model.parameters()]
        fn(model, None)
        return all(torch.equal(a, p) for a, p in zip(before,
                                                     model.parameters()))
    finally:
        tdist.destroy_process_group()


@pytest.mark.parametrize("case", list(HONOURED))
def test_formerly_unported_parameter_is_honoured(case):
    assert HONOURED[case]()


# ---------------------------------------------------------------------------
# parameters the port honours
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("padding_idx", [None, 3, -2])
def test_embedding_padding_idx_matches_jax(padding_idx):
    rs = np.random.RandomState(0)
    w = rs.randn(10, 4).astype(np.float32)
    ids = np.array([[3, 8, 1], [8, 3, 0]])
    want = np.asarray(jF.embedding(Tensor(ids), Tensor(w),
                                   padding_idx=padding_idx)._data)
    got = tF.embedding(torch.from_numpy(ids), torch.from_numpy(w),
                       padding_idx=padding_idx, sparse=True).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def engine_model():
    return _tiny_gpt()


def test_submit_takes_the_request_id_and_rejects_trace(engine_model,
                                                      tmp_path):
    """``request_id`` names the request; ``trace`` is honoured (a
    ``TraceContext`` parents the request's root span, as in the
    reference), and so is ``deadline_s`` (a deadline the request meets
    changes nothing)."""
    eng = tengine.ServingEngine(engine_model, max_batch=2, page_size=8,
                                device="cpu").start()
    parent = ttracing.TraceContext(ttracing.new_trace_id(),
                                   ttracing.new_span_id())
    set_flags({"FLAGS_observability_dir": str(tmp_path)})
    try:
        req = eng.submit([1, 2, 3], max_new_tokens=2, request_id="r-7")
        assert req.id == "r-7"
        assert len(req.wait(timeout=60)) == 2
        traced = eng.submit([1, 2, 3], max_new_tokens=2, trace=parent)
        assert len(traced.wait(timeout=60)) == 2
        assert traced.trace.trace_id == parent.trace_id
        assert traced.trace.span_id != parent.span_id
        timed = eng.submit([1, 2, 3], max_new_tokens=2, deadline_s=60.0)
        assert timed.deadline_s == 60.0 and len(timed.wait(timeout=60)) == 2
    finally:
        set_flags({"FLAGS_observability_dir": ""})
        eng.stop()


def test_stop_returns_the_reference_keys(engine_model):
    """``stop`` returns the reference's keys: the engine's id, its
    health and whether the loop thread failed to join; ``stop(False)``
    fails what is queued instead of draining it."""
    paddle.seed(0)
    jm = jgpt.GPTForPretraining(jgpt.gpt_config(
        "tiny", hidden_dropout_prob=0.0, attention_dropout_prob=0.0))
    jeng = jengine.ServingEngine(jm, max_batch=2, page_size=8).start()
    want = set(jeng.stop())
    eng = tengine.ServingEngine(engine_model, max_batch=2, page_size=8,
                                device="cpu").start()
    res = eng.stop()
    assert set(res) == want == {"engine", "health", "wedged"}
    assert res == {"engine": eng.engine_id, "health": "ok",
                   "wedged": False}
    eng = tengine.ServingEngine(engine_model, max_batch=2, page_size=8,
                                device="cpu")
    eng._running = eng._accepting = True      # accepting, no loop thread
    req = eng.submit([1, 2, 3], max_new_tokens=4)
    assert eng.stop(False) == {"engine": eng.engine_id, "health": "ok",
                               "wedged": False}
    assert req.done and req.error == "engine stopped"


def test_weight_decay_and_name_reach_the_base():
    opt = optimizer.AdamW(parameters=_param(), weight_decay=0.05, name="o")
    assert opt._weight_decay == 0.05 and opt._wd == 0.05
    assert opt._name == "o"


@pytest.mark.parametrize("set_to_zero", [True, False])
def test_clear_grad_drops_gradients_as_the_reference(set_to_zero):
    p = _param()
    opt = optimizer.AdamW(parameters=p)
    p[0].grad = torch.ones(3)
    opt.clear_grad(set_to_zero)
    assert p[0].grad is None


def test_decorate_keeps_excluded_layers_in_fp32():
    m = torch.nn.Sequential(torch.nn.Linear(2, 2), torch.nn.Conv1d(2, 2, 1))
    amp.decorate(m, level="O2", dtype="bfloat16",
                 excluded_layers=[torch.nn.Conv1d])
    assert m[0].weight.dtype == torch.bfloat16
    assert m[1].weight.dtype == torch.float32


def test_attention_training_flag_drives_dropout():
    """``training=False`` is the eval attention whatever the module's mode;
    ``training=True`` drops (attention dropout 0.5)."""
    m = GPTForPretraining(gpt_config("tiny", hidden_dropout_prob=0.0,
                                     attention_dropout_prob=0.5),
                          device="cpu")
    attn = m.gpt.layers[0].attn
    x = torch.from_numpy(np.random.RandomState(1).randn(
        2, 5, 64).astype(np.float32))
    m.eval()
    want = attn(x, training=False)
    m.train()
    torch.testing.assert_close(attn(x, training=False), want, rtol=0,
                               atol=0)
    assert not torch.equal(attn(x, training=True), want)


def test_generate_takes_generator_by_keyword_only():
    m = _tiny_gpt()
    ids = np.random.RandomState(2).randint(0, 512, (1, 4))
    params = inspect.signature(tgen.generate).parameters
    assert params["generator"].kind is inspect.Parameter.KEYWORD_ONLY
    out = tgen.generate(m, ids, 2, None, "sampling", 1.0, 0, 1.0, None, 1,
                        1.0, None, True, False, None,
                        generator=torch.Generator().manual_seed(0))
    again = tgen.generate(m, ids, 2, decode_strategy="sampling",
                          generator=torch.Generator().manual_seed(0))
    assert out.shape == (1, 6) and torch.equal(out, again)
    with pytest.raises(TypeError):
        tgen.generate(m, ids, 2, None, "greedy_search", 1.0, 0, 1.0, None,
                      1, 1.0, None, True, False, None,
                      torch.Generator())


def test_flash_attention_takes_the_reference_positionals():
    """A reference-order call binds the block sizes and ``interpret``
    where the reference has them: seven positionals (the default blocks)
    and ten (blocks, ``interpret``, ``q_offset``, ``n_rep``) equal the
    keyword calls."""
    rs = np.random.RandomState(3)
    q = torch.tensor(rs.randn(4, 6, 8).astype(np.float32))
    k = torch.tensor(rs.randn(2, 9, 8).astype(np.float32))
    v = torch.tensor(rs.randn(2, 9, 8).astype(np.float32))
    f = tfa.flash_attention_bhsd
    assert torch.equal(f(q, k[:1].repeat(4, 1, 1), v[:1].repeat(4, 1, 1),
                         0.3, True, 128, 128),
                       f(q, k[:1].repeat(4, 1, 1), v[:1].repeat(4, 1, 1),
                         0.3, True))
    assert torch.equal(f(q, k, v, 0.3, True, 128, 128, True, 3, 2),
                       f(q, k, v, 0.3, True, q_offset=3, n_rep=2))


def test_fused_rms_norm_takes_keywords_as_the_reference():
    """Keywords the reference ignores are taken; Paddle's own at their
    defaults change nothing."""
    x, w = torch.randn(2, 4), torch.rand(4)
    want = tinc.fused_rms_norm(x, w)[0]
    got = tinc.fused_rms_norm(x, w, residual=None, quant_scale=-1,
                              unknown_key=1)[0]
    assert torch.equal(got, want)
