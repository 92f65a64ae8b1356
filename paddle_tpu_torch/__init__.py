"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

Beside the JAX package, which stays the reference, this package runs
the same models on an NVIDIA H100 with its TPU kernels rewritten by hand
in CUDA C++ for ``sm_90a``. It imports torch, never jax, and nothing of
``paddle_tpu``. Entry points run on the card unless the caller passes
``device="cpu"`` (or said ``set_device("cpu")``); on CPU tensors every
kernel wrapper computes its plain PyTorch version.

The namespace is the JAX package's ``paddle.*`` for everything the port
has: the eager API (``Tensor``, ``to_tensor``, the functions of
``tensor``, ``grad``, ``no_grad``, ``seed``, ``set_device``, the
dtypes, ``nn.Layer``), so ``import paddle_tpu_torch as paddle`` runs a
dygraph training loop (``loss.backward(); opt.step();
opt.clear_grad()``). ``core/tensor.py`` says where Paddle semantics stop:
the facade ``Tensor`` is what user code sees, and inside the port's
modules and torch every tensor is a plain ``torch.Tensor``.

What it runs: GPT served end to end (``models``, ``serving``: paged KV,
continuous batching, int8 pools, LoRA adapters, bf16, the radix prefix
cache, chunked prefill and speculative decoding) through the flash,
paged-decode and bgmv kernels (``ops.kernels``); GPT, BERT and ERNIE
trained through ``jit.TrainStep`` or the eager loop (``nn``, ``amp``,
``optimizer``) on the flash forward and backward, chunked cross-entropy
and fused dropout kernels; int8 inference (``inference``, ``slim``,
``nn.quant``) through the int8 matmul kernel. Models are saved and
loaded as the JAX package saves them (``save`` / ``load``, ``jit.save``
/ ``jit.load``, ``inference.Config(model_path)``, ``TrainStep.save`` /
``load``), and ``io`` feeds a training loop from a dataset.
``monitor``, ``testing.chaos``, ``profiler`` and ``cost_model`` observe
all of it with the JAX package's metric names, flags and fault-injection
sites. ``distributed`` trains over data and tensor parallelism with
ZeRO-1, gradient accumulation and activation recompute, one process a
rank (``torch.distributed``). ``incubate.moe`` adds the
Mixture-of-Experts layer and the MoE GPT. ``vision`` holds the zoo
models, the detection ops and the data side; ``hapi.Model`` trains,
evaluates and predicts over them, with ``metric`` and ``callbacks``.
``recsys`` holds the giant embedding tables that ``models.dlrm`` trains
through and ``recsys.RecsysEngine`` ranks with.
"""

import torch as _torch

from .core import make_generator, resolve_device
from .core.device import (CPUPlace, CUDAPinnedPlace, CUDAPlace,  # noqa
                          NPUPlace, Place, TPUPlace, device_count,
                          get_device, is_compiled_with_cuda,
                          is_compiled_with_tpu, set_device)
from .core.dtype import (bfloat16, bool_, complex64, complex128,  # noqa
                         float16, float32, float64, get_default_dtype, int8,
                         int16, int32, int64, set_default_dtype, uint8)
from .core.dtype import bool_ as bool  # noqa: A004
from .core.flags import get_flags, set_flags  # noqa: F401
from .core.random import get_rng_state, seed, set_rng_state  # noqa: F401
from .core.random import get_rng_state as get_cuda_rng_state  # noqa
from .core.random import set_rng_state as set_cuda_rng_state  # noqa
from .core.tensor import (Parameter, Tensor, enable_grad,  # noqa: F401
                          is_grad_enabled, no_grad, set_grad_enabled)

#: ``paddle.dtype``, the type of the dtype objects
dtype = _torch.dtype

from .tensor import *  # noqa: E402,F401,F403
from . import tensor  # noqa: E402,F401

from . import (amp, autograd, callbacks, cost_model, device,  # noqa: E402
               distributed, framework, hapi, incubate, inference, io, jit,
               linalg, metric, monitor, nn, optimizer, profiler, slim,
               vision)
from .autograd.functional import grad  # noqa: E402,F401
from .distributed.parallel import DataParallel  # noqa: E402,F401
from .framework import (disable_static, enable_static,  # noqa: E402,F401
                        in_dynamic_mode, load, save)
from .hapi import summary  # noqa: E402,F401
from .hapi.model import Model  # noqa: E402,F401
from .nn.initializer import ParamAttr  # noqa: E402,F401
from .nn.layer import Layer  # noqa: E402,F401
from .tensor.einsum import einsum  # noqa: E402,F401
