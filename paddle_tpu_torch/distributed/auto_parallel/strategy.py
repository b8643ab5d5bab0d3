"""The semi-auto ``Strategy``; counterpart of
``paddle_tpu/distributed/auto_parallel/strategy.py`` (ref:
``python/paddle/distributed/auto_parallel/strategy.py``): the knob
object with the reference's field names.  A dict config merges into the
typed sub-configs.  ``Engine`` reads ``tuning`` only, as the JAX
package's does; the other configs are accepted and read by nothing."""
from __future__ import annotations


class _Config:
    def __init__(self, **kw):
        self.__dict__.update(kw)

    def __repr__(self):
        return f"{type(self).__name__}({self.__dict__})"


class ShardingConfig(_Config):
    def __init__(self):
        super().__init__(enable=False, stage=1, degree=-1,
                         enable_overlap=False)


class AMPConfig(_Config):
    def __init__(self):
        super().__init__(enable=False, dtype="float16", level="O1",
                         init_loss_scaling=32768.0, custom_white_list=[],
                         custom_black_list=[], use_master_grad=False)


class RecomputeConfig(_Config):
    def __init__(self):
        super().__init__(enable=False, sr=0, refined_ops_patterns=[])


class PipelineConfig(_Config):
    def __init__(self):
        super().__init__(enable=False, schedule_mode="1F1B",
                         micro_batch_size=1, accumulate_steps=1)


class GradientMergeConfig(_Config):
    def __init__(self):
        super().__init__(enable=False, k_steps=1, avg=True)


class MPOptimizationConfig(_Config):
    def __init__(self):
        super().__init__(enable=False, replace_with_parallel_cross_entropy=False)


class TuningConfig(_Config):
    """ref: tuner/ config — rule-based + profile search knobs."""

    def __init__(self):
        super().__init__(enable=False, profile=False, candidates=None)


class FusedPassesConfig(_Config):
    """ref: strategy.FusedPassesConfig — named fusion passes, accepted
    and not interpreted."""

    def __init__(self):
        super().__init__(enable=False, fused_passes_list=[])


class DPOptimizationConfig(_Config):
    def __init__(self):
        super().__init__(enable=False, fuse_all_reduce_ops=True,
                         fuse_grad_size_in_MB=32, overlap_comm_cacl=True)


class SPOptimizationConfig(_Config):
    def __init__(self):
        super().__init__(enable=False)


class QATConfig(_Config):
    def __init__(self):
        super().__init__(enable=False, channel_wise_abs_max=True,
                         weight_bits=8, activation_bits=8,
                         not_quant_pattern=[], algo=None)


class DatasetConfig(_Config):
    def __init__(self):
        super().__init__(enable=False, num_shards=1)


class Strategy(_Config):
    def __init__(self, config=None):
        super().__init__()
        self.auto_mode = "semi"
        self.sharding = ShardingConfig()
        self.amp = AMPConfig()
        self.recompute = RecomputeConfig()
        self.pipeline = PipelineConfig()
        self.gradient_merge = GradientMergeConfig()
        self.mp_optimization = MPOptimizationConfig()
        self.dp_optimization = DPOptimizationConfig()
        self.sp_optimization = SPOptimizationConfig()
        self.fused_passes = FusedPassesConfig()
        self.qat = QATConfig()
        self.dataset = DatasetConfig()
        self.tuning = TuningConfig()
        self.split_data = True
        self.gradient_scale_using_world_size = False
        self.seed = None
        if config:
            for k, v in dict(config).items():
                cur = getattr(self, k, None)
                if isinstance(cur, _Config) and isinstance(v, dict):
                    # the reference's dict-config shape merges into the
                    # typed sub-config, it doesn't replace it
                    for kk, vv in v.items():
                        setattr(cur, kk, vv)
                else:
                    setattr(self, k, v)
