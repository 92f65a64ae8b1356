"""parallel_layers: the tensor-parallel building blocks, the RNG
tracker and the pipeline's layer descriptions."""

from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,  # noqa
                        RowParallelLinear, VocabParallelEmbedding, split)
from .pp_layers import (LayerDesc, PipelineLayer,  # noqa: F401
                        SegmentLayers, SharedLayerDesc)
from .random import (RNGStatesTracker, get_rng_state_tracker,  # noqa: F401
                     model_parallel_random_seed)
