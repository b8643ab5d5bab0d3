"""``paddle.incubate.distributed.models.moe`` of the port: ``MoELayer``,
its gates and the MoE gradient clip (``moe_layer.py``)."""
from .moe_layer import (BaseGate, ClipGradForMOEByGlobalNorm, GShardGate,
                        MoELayer, NaiveGate, SwitchGate)

__all__ = ["MoELayer", "NaiveGate", "GShardGate", "SwitchGate", "BaseGate",
           "ClipGradForMOEByGlobalNorm"]
