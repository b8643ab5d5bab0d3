"""``paddle.nn.utils``' gradient clips; counterpart of
``paddle_tpu/nn/utils/__init__.py`` (the functions live in ``nn.clip``,
as there)."""
from .clip import clip_grad_norm_, clip_grad_value_

__all__ = ["clip_grad_norm_", "clip_grad_value_"]
