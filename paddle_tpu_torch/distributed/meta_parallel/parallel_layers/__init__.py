"""parallel_layers: the tensor-parallel building blocks and the RNG
tracker (``pp_layers`` comes with the pipeline)."""

from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,  # noqa
                        RowParallelLinear, VocabParallelEmbedding, split)
from .random import (RNGStatesTracker, get_rng_state_tracker,  # noqa: F401
                     model_parallel_random_seed)
