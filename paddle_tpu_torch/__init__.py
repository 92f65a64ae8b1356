"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

Beside the JAX package, which stays the reference, this package runs
the same models on an NVIDIA H100 with its TPU kernels rewritten by hand
in CUDA C++ for ``sm_90a``. It imports torch, never jax, and nothing of
``paddle_tpu``. Entry points run on the card unless the caller passes
``device="cpu"``; on CPU tensors every kernel wrapper computes its plain
PyTorch version.

First slice: GPT served end to end (``models``, ``serving``) through the
flash-prefill and paged-decode kernels (``ops.kernels``). Second slice:
GPT pretrained through ``jit.TrainStep`` (``nn``, ``amp``,
``optimizer``), with the flash backward, chunked cross-entropy and fused
dropout kernels. Third: BERT and ERNIE trained on padded batches
through the biased flash kernels. Fourth: multi-tenant GPT serving
(int8 paged KV, LoRA) through the quantized paged-decode and bgmv
kernels. Fifth: int8 inference (``inference``, ``slim``, ``nn.quant``)
through the int8 matmul kernel, the last of the JAX package's TPU
kernels.
"""

from .core import make_generator, resolve_device

__all__ = ["make_generator", "resolve_device"]
