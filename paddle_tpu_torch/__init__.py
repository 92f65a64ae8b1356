"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

Beside the JAX package, which stays the reference, this package runs
the same models on an NVIDIA H100 with its TPU kernels rewritten by hand
in CUDA C++ for ``sm_90a``. It imports torch, never jax, and nothing of
``paddle_tpu``. Entry points run on the card unless the caller passes
``device="cpu"``; on CPU tensors every kernel wrapper computes its plain
PyTorch version.

What it runs: GPT served end to end (``models``, ``serving``: paged KV,
continuous batching, int8 pools, LoRA adapters, bf16, the radix prefix
cache, chunked prefill and speculative decoding) through the flash,
paged-decode and bgmv kernels (``ops.kernels``); GPT, BERT and ERNIE
trained through ``jit.TrainStep`` (``nn``, ``amp``, ``optimizer``) on
the flash forward and backward, chunked cross-entropy and fused dropout
kernels; int8 inference (``inference``, ``slim``, ``nn.quant``) through
the int8 matmul kernel. Models are saved and loaded as the JAX package
saves them (``save`` / ``load``, ``jit.save`` / ``jit.load``,
``inference.Config(model_path)``, ``TrainStep.save`` / ``load``), and
``io`` feeds a training loop from a dataset. ``monitor``,
``testing.chaos``, ``profiler`` and ``cost_model`` observe all of it
with the JAX package's metric names, flags and fault-injection sites.
``distributed`` trains over data and tensor parallelism with ZeRO-1,
gradient accumulation and activation recompute, one process a rank
(``torch.distributed``). ``incubate.moe`` adds the Mixture-of-Experts
layer (routing, sort and einsum dispatch, the expert-parallel program
over an ``ep`` mesh axis) and the MoE GPT (``GPTConfig.moe_experts``).
``vision`` holds the zoo models, the detection ops (``vision.ops``) and
the data side; ``hapi.Model`` trains, evaluates and predicts over them
(data-parallel under ``fleet.init``), with ``metric`` and ``callbacks``.
``recsys`` holds the giant embedding tables (tiered, ps-sharded, on the
host and the PS server of ``distributed.ps``) that ``models.dlrm``
trains through and ``recsys.RecsysEngine`` ranks with.
"""

from .core import make_generator, resolve_device
from .framework import (disable_static, enable_static, in_dynamic_mode,
                        load, save)

__all__ = ["disable_static", "enable_static", "in_dynamic_mode", "load",
           "make_generator", "resolve_device", "save"]
