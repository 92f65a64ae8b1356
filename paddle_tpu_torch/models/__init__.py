"""Models (counterpart of ``paddle_tpu.models``): GPT for serving and
pretraining, BERT and ERNIE for pretraining, and ``generate`` over a
static KV cache."""

from .bert import (BertConfig, BertForMaskedLM, BertModel, bert_base,
                   bert_large, bert_tiny)
from .convert import load_jax_weights, torch_state_dict_from_jax
from .ernie import (ErnieConfig, ErnieForPretraining, ErnieModel,
                    ernie_base, ernie_tiny)
from .generation import generate
from .gpt import (GPTConfig, GPTForPretraining, GPTModel,
                  GPTPretrainingCriterion, gpt2_large, gpt2_medium,
                  gpt2_small, gpt2_xl, gpt_tiny, parallel_logits)

__all__ = ["BertConfig", "BertForMaskedLM", "BertModel", "ErnieConfig",
           "ErnieForPretraining", "ErnieModel", "GPTConfig",
           "GPTForPretraining", "GPTModel", "GPTPretrainingCriterion",
           "bert_base", "bert_large", "bert_tiny", "ernie_base",
           "ernie_tiny", "generate", "gpt2_large", "gpt2_medium",
           "gpt2_small", "gpt2_xl", "gpt_tiny", "load_jax_weights",
           "parallel_logits", "torch_state_dict_from_jax"]
