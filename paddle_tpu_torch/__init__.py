"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu`` for an
NVIDIA H100.

The JAX package ``paddle_tpu`` stays the reference; this package
imports neither JAX nor anything of ``paddle_tpu``.  Its first slice is
the serving path: ``models.gpt.GPTForPretraining`` served by
``serving.ServingEngine`` (continuous batching over paged KV pools),
whose attention is the hand-written CUDA kernel in
``ops/csrc/ragged_paged_attention.cu``.
"""
from .device import default_device, generator, seed

__version__ = "0.1.0"

__all__ = ["default_device", "generator", "seed", "__version__"]
