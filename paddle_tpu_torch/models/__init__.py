"""Models (counterpart of ``paddle_tpu.models``): GPT for serving and
pretraining."""

from .convert import load_jax_weights, torch_state_dict_from_jax
from .gpt import (GPTConfig, GPTForPretraining, GPTModel,
                  GPTPretrainingCriterion, gpt2_large, gpt2_medium,
                  gpt2_small, gpt2_xl, gpt_tiny, parallel_logits)

__all__ = ["GPTConfig", "GPTForPretraining", "GPTModel",
           "GPTPretrainingCriterion", "gpt2_large", "gpt2_medium",
           "gpt2_small", "gpt2_xl", "gpt_tiny", "load_jax_weights",
           "parallel_logits", "torch_state_dict_from_jax"]
