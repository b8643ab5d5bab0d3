"""Models of the port: GPT, LLaMA, BART and ERNIE-MoE."""
from .bart import BartConfig, BartForConditionalGeneration
from .carry import load_paddle_tpu_state, load_stage_state
from .ernie_moe import (ERNIE_MOE_PRESETS, ErnieMoEConfig,
                        ErnieMoEForPretraining, ErnieMoEModel,
                        ernie_moe_config)
from .gpt import PRESETS, GPTConfig, GPTForPretraining, gpt_config
from .llama import (LLAMA_PRESETS, LlamaConfig, LlamaForCausalLM,
                    llama_config, llama_pipeline_step)

__all__ = ["BartConfig", "BartForConditionalGeneration", "ERNIE_MOE_PRESETS",
           "ErnieMoEConfig", "ErnieMoEForPretraining", "ErnieMoEModel",
           "ernie_moe_config", "GPTConfig",
           "GPTForPretraining", "PRESETS", "gpt_config", "LLAMA_PRESETS", "LlamaConfig", "LlamaForCausalLM",
           "llama_config", "llama_pipeline_step", "load_paddle_tpu_state",
           "load_stage_state"]
