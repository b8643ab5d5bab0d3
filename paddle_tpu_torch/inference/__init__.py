"""paddle_tpu_torch.inference — HTTP serving of the continuous-batching
engine (:mod:`~.serving`: ``InferenceServer``, ``generate_http``).  The
JAX package's ``Predictor`` (the ``jit.save`` artifact runtime) is not
ported."""
from .serving import InferenceServer, generate_http

__all__ = ["InferenceServer", "generate_http"]
