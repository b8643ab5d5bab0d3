"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu`` for an
NVIDIA H100.

The JAX package ``paddle_tpu`` stays the reference; this package
imports neither JAX nor anything of ``paddle_tpu``.  Ported so far:
``models.gpt.GPTForPretraining`` and ``models.llama.LlamaForCausalLM``
served by ``serving.ServingEngine`` (continuous batching over paged KV
pools, attention in ``ops/csrc/ragged_paged_attention.cu``; fused decode
windows; HTTP ``/generate`` in ``inference.serving``; metrics, events
and request traces in ``observability``), the pretraining step
(``jit.train_step`` with ``amp`` O2 and ``optimizer.AdamW``) of GPT and
of ``models.llama.LlamaForCausalLM``, and their decode loops
(``models.generation.generate`` and ``decode_loop``, the latter on the
fused decode kernels of ``ops/csrc/fused_decode.cu``), eager paged
``generate`` and beam search, ``models.bart`` training and generation,
and the static Program capture (``static.capture_ops``) with its pass
pipeline (``static.passes``, verified by ``analysis.pass_check``), whose
kernel-claim pass puts a captured decode step's norm -> matmul chains on
``ops.fused_decode.norm_matmul``; all on the hand-written CUDA kernels
of ``ops/csrc/``.  ``save`` / ``load`` (``framework.io``) read and
write Paddle's pickle format, the JAX package's files included;
``distributed.checkpoint`` saves and loads sharded training state and
``resilience`` keeps a training run going through crashes, stalls and
preemption; ``distributed.auto_parallel`` holds the semi-auto API and
its ``Engine``, which reads batches through ``io.DataLoader``.
"""
from .device import default_device, generator, seed
from .framework.io import load, save

__version__ = "0.1.0"

__all__ = ["default_device", "generator", "seed", "save", "load",
           "__version__"]
