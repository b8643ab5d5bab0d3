"""Models of the port: GPT, LLaMA and BART."""
from .bart import BartConfig, BartForConditionalGeneration
from .carry import load_paddle_tpu_state, load_stage_state
from .gpt import PRESETS, GPTConfig, GPTForPretraining, gpt_config
from .llama import (LLAMA_PRESETS, LlamaConfig, LlamaForCausalLM,
                    llama_config, llama_pipeline_step)

__all__ = ["BartConfig", "BartForConditionalGeneration", "GPTConfig",
           "GPTForPretraining", "PRESETS", "gpt_config", "LLAMA_PRESETS", "LlamaConfig", "LlamaForCausalLM",
           "llama_config", "llama_pipeline_step", "load_paddle_tpu_state",
           "load_stage_state"]
