"""meta_parallel: the hybrid-parallel model wrappers and the
tensor-parallel layers (counterpart of
``paddle_tpu/distributed/meta_parallel``; the pipeline comes with the
second part of ``distributed/``)."""

from .parallel_base import ShardingParallel, TensorParallel  # noqa: F401
from .parallel_layers import (ColumnParallelLinear,  # noqa: F401
                              ParallelCrossEntropy, RowParallelLinear,
                              VocabParallelEmbedding)
from . import parallel_layers  # noqa: F401
