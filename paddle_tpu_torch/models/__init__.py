"""Models (counterpart of ``paddle_tpu.models``): GPT (dense or MoE,
``GPTConfig.moe_experts``) for serving and pretraining (and over the pipeline: ``GPTForPretrainingPipe``,
``build_gpt_pipe``; sequence-parallel with ``sequence_parallel``), BERT
and ERNIE for pretraining (tensor-parallel through
``apply_hybrid_specs``; ERNIE-3.0 1.5B as ``ernie_3_1p5b``), DLRM over
the recsys embedding tables (``dlrm``), and ``generate`` over a static
KV cache."""

from .bert import (BertConfig, BertForMaskedLM, BertModel, bert_base,
                   bert_large, bert_tiny)
from .convert import (gather_state_dict, load_jax_weights,
                      shard_state_dict, torch_state_dict_from_jax)
from .dlrm import DLRM, DLRMConfig, TableEmbedding, dlrm_tiny
from .ernie import (ErnieConfig, ErnieForPretraining, ErnieModel,
                    ernie_3_1p5b, ernie_base, ernie_tiny)
from .generation import generate
from .gpt import (GPTConfig, GPTForPretraining, GPTForPretrainingPipe,
                  GPTModel, GPTPretrainingCriterion, build_gpt_pipe,
                  gpt2_large, gpt2_medium, gpt2_small, gpt2_xl,
                  gpt_pipeline_descs, gpt_tiny, parallel_logits)

__all__ = ["BertConfig", "BertForMaskedLM", "BertModel", "DLRM",
           "DLRMConfig", "TableEmbedding", "dlrm_tiny", "ErnieConfig",
           "ErnieForPretraining", "ErnieModel", "GPTConfig",
           "GPTForPretraining", "GPTForPretrainingPipe", "GPTModel",
           "GPTPretrainingCriterion", "build_gpt_pipe", "gpt_pipeline_descs",
           "bert_base", "bert_large", "bert_tiny", "ernie_3_1p5b",
           "ernie_base", "ernie_tiny", "gather_state_dict", "generate", "gpt2_large", "gpt2_medium",
           "gpt2_small", "gpt2_xl", "gpt_tiny", "load_jax_weights",
           "parallel_logits", "shard_state_dict", "torch_state_dict_from_jax"]
