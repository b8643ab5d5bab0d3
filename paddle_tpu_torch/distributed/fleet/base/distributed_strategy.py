"""DistributedStrategy; a copy of
``paddle_tpu/distributed/fleet/base/distributed_strategy.py`` (ref:
``python/paddle/distributed/fleet/base/distributed_strategy.py``).

A plain attribute object with the reference's field names.
``hybrid_configs`` carries the degrees ``fleet.init`` builds the rank
grid from, ``find_unused_parameters`` and ``gradient_merge`` /
``gradient_merge_configs`` are read by ``fleet``; the other knobs are
accepted and read by nothing in the port.
"""
from __future__ import annotations

from typing import Any, Dict


class _Bunch(dict):
    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v


_HYBRID_DEFAULTS = {
    "dp_degree": 1,
    "mp_degree": 1,
    "pp_degree": 1,
    "sharding_degree": 1,
    "sep_degree": 1,
    "cp_degree": 1,
    "ep_degree": 1,
    "order": ["dp", "pp", "sharding", "sep", "cp", "mp"],
    "mp_configs": _Bunch(),
    "pp_configs": _Bunch(),
}


class DistributedStrategy:
    def __init__(self):
        # execution/graph knobs (accepted for parity)
        self.auto = False
        self.a_sync = False
        self.sync_nccl_allreduce = False
        self.nccl_comm_num = 1
        self.find_unused_parameters = False
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        self.gradient_scale_configs = _Bunch(scale_strategy="avg")
        self.without_graph_optimization = False

        # amp
        self.amp = False
        self.amp_configs = _Bunch(
            init_loss_scaling=32768.0, incr_every_n_steps=1000,
            decr_every_n_nan_or_inf=2, incr_ratio=2.0, decr_ratio=0.5,
            use_dynamic_loss_scaling=True, custom_white_list=[],
            custom_black_list=[], use_pure_fp16=False, use_fp16_guard=False,
            use_bf16=False)

        # recompute
        self.recompute = False
        self.recompute_configs = _Bunch(checkpoints=[], enable_offload=False)

        # pipeline
        self.pipeline = False
        self.pipeline_configs = _Bunch(
            micro_batch_size=1, accumulate_steps=1, schedule_mode="1F1B",
            p2p_cache_shape=True)

        # tensor parallel (static-graph style knobs)
        self.tensor_parallel = False
        self.tensor_parallel_configs = _Bunch(tensor_parallel_degree=1)

        # sharding
        self.sharding = False
        self.sharding_configs = _Bunch(
            sharding_degree=1, stage=1, segment_broadcast_MB=32.0,
            comm_overlap=False, split_param=False, offload=False)

        # gradient merge
        self.gradient_merge = False
        self.gradient_merge_configs = _Bunch(k_steps=1, avg=True)

        # lamb / lars / dgc / localsgd — accepted for parity
        self.lamb = False
        self.lamb_configs = _Bunch(lamb_weight_decay=0.01,
                                   exclude_from_weight_decay=[])
        self.lars = False
        self.lars_configs = _Bunch(lars_coeff=0.001, lars_weight_decay=0.0005,
                                   epsilon=0.0, exclude_from_weight_decay=[])
        self.dgc = False
        self.dgc_configs = _Bunch(rampup_begin_step=0, rampup_step=1,
                                  sparsity=[0.999])
        self.localsgd = False
        self.localsgd_configs = _Bunch(k_steps=1, begin_step=1)
        self.adaptive_localsgd = False
        self.adaptive_localsgd_configs = _Bunch(init_k_steps=1, begin_step=1)

        # hybrid parallel degrees — the mesh definition
        self.hybrid_configs = {k: (dict(v) if isinstance(v, dict) else
                                   (list(v) if isinstance(v, list) else v))
                               for k, v in _HYBRID_DEFAULTS.items()}

        self.heter_ccl_mode = False
        self.is_fl_ps_mode = False

        # a_sync (parameter-server era) — accepted, PS is out of scope
        self.a_sync_configs = _Bunch(k_steps=-1, max_merge_var_num=1,
                                     send_queue_size=16,
                                     independent_recv_thread=False,
                                     thread_pool_size=1, send_wait_times=1,
                                     runtime_split_send_recv=False)

        # quantization / sparsity meta-knobs (flows live in
        # paddle.quantization / incubate.asp; the strategy bits gate them
        # the way the reference's meta-optimizers do)
        self.qat = False
        self.qat_configs = _Bunch(channel_wise_abs_max=True,
                                  weight_bits=8, activation_bits=8,
                                  not_quant_pattern=[], algo="")
        self.asp = False

        # comm-tuning knobs: accepted for API parity (DataParallel's
        # bucket sizes are its own parameters)
        self.fp16_allreduce = False
        self.use_hierarchical_allreduce = False
        self.hierarchical_allreduce_inter_nranks = 0
        self.last_comm_group_size_MB = 1.0
        self.calc_comm_same_stream = False
        self.fuse_grad_merge = False
        self.fuse_grad_size_in_num = 8
        self.sync_batch_norm = False

        # cudnn autotune knobs: accepted for parity
        self.cudnn_exhaustive_search = False
        self.conv_workspace_size_limit = 512
        self.cudnn_batchnorm_spatial_persistent = False

        # semi-auto parallel gate (auto_parallel Engine consumes it)
        self.semi_auto = False

        # execution/build strategy sub-objects (static-graph era shells)
        self.execution_strategy = _Bunch(num_threads=1,
                                         num_iteration_per_drop_scope=10,
                                         num_iteration_per_run=1,
                                         use_thread_barrier=False)
        self.build_strategy = _Bunch(
            enable_sequential_execution=False, fuse_elewise_add_act_ops=False,
            fuse_bn_act_ops=False, fuse_relu_depthwise_conv=False,
            fuse_broadcast_ops=False, fuse_all_optimizer_ops=False,
            enable_inplace=True, enable_addto=False,
            cache_runtime_context=False)

    # -- prototxt round-trip (ref: save_to_prototxt/load_from_prototxt on
    # the protobuf-backed strategy; here a key=value text dump) ----------
    def save_to_prototxt(self, output):
        import json
        payload = {}
        for k, v in vars(self).items():
            key = k.lstrip("_")
            payload[key] = dict(v) if isinstance(v, dict) else v
        with open(output, "w") as f:
            json.dump(payload, f, indent=2, default=str)

    def load_from_prototxt(self, pb_file):
        import json
        with open(pb_file) as f:
            payload = json.load(f)
        for k, v in payload.items():
            if k == "hybrid_configs":
                self.hybrid_configs = v
            elif isinstance(v, dict):
                setattr(self, k, _Bunch(v))
            else:
                setattr(self, k, v)

    @property
    def hybrid_configs(self):
        return self._hybrid_configs

    @hybrid_configs.setter
    def hybrid_configs(self, configs: Dict[str, Any]):
        merged = dict(getattr(self, "_hybrid_configs", _HYBRID_DEFAULTS))
        for k, v in configs.items():
            if k in ("mp_configs", "pp_configs") and isinstance(v, dict):
                b = _Bunch(merged.get(k, {}))
                b.update(v)
                v = b
            merged[k] = v
        self._hybrid_configs = _Bunch(merged)

    def __repr__(self):
        hc = self._hybrid_configs
        return (f"DistributedStrategy(dp={hc['dp_degree']}, "
                f"mp={hc['mp_degree']}, pp={hc['pp_degree']}, "
                f"sharding={hc['sharding_degree']}, sep={hc['sep_degree']})")


Strategy = DistributedStrategy
