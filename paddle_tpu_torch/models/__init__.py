"""Models of the port (GPT so far)."""
from .carry import load_paddle_tpu_state
from .gpt import PRESETS, GPTConfig, GPTForPretraining, gpt_config

__all__ = ["GPTConfig", "GPTForPretraining", "PRESETS", "gpt_config",
           "load_paddle_tpu_state"]
