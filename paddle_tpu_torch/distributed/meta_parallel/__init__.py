"""meta_parallel: the hybrid-parallel model wrappers, the
tensor-parallel layers and the pipeline (counterpart of
``paddle_tpu/distributed/meta_parallel``): ``TensorParallel``,
``ShardingParallel``, ``PipelineParallel`` over a ``PipelineLayer`` of
layer descriptions, and ``spmd_pipeline``'s ``PipelineStageStack``
with its 1F1B and fill-drain schedules."""

from .parallel_base import ShardingParallel, TensorParallel  # noqa: F401
from .parallel_layers import (ColumnParallelLinear,  # noqa: F401
                              LayerDesc, ParallelCrossEntropy,
                              PipelineLayer, RowParallelLinear,
                              SegmentLayers, SharedLayerDesc,
                              VocabParallelEmbedding)
from .pipeline_parallel import PipelineParallel  # noqa: F401
from .spmd_pipeline import (PIPELINE_STATS, PipelineStageStack,  # noqa: F401
                            resolve_schedule)
from . import parallel_layers  # noqa: F401


def __getattr__(name):
    if name in ("GPTForPretrainingPipe", "build_gpt_pipe"):
        from ...models import gpt
        return getattr(gpt, name)
    raise AttributeError(
        "module 'paddle_tpu_torch.distributed.meta_parallel' has no "
        f"attribute {name!r}")
