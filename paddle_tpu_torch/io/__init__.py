"""The input pipeline (counterpart of ``paddle_tpu.io``): datasets,
samplers and the DataLoader that feeds a training loop on the card."""

from .dataloader import (DataLoader, WorkerInfo, default_collate_fn,
                         get_worker_info)
from .dataset import (ChainDataset, ComposeDataset, ConcatDataset, Dataset,
                      IterableDataset, RandomSplit, Subset, TensorDataset,
                      random_split)
from .sampler import (BatchSampler, DistributedBatchSampler, RandomSampler,
                      Sampler, SequenceSampler, SubsetRandomSampler,
                      WeightedRandomSampler)

__all__ = ["BatchSampler", "ChainDataset", "ComposeDataset",
           "ConcatDataset", "DataLoader", "Dataset",
           "DistributedBatchSampler", "IterableDataset", "RandomSampler",
           "RandomSplit", "Sampler", "SequenceSampler", "Subset",
           "SubsetRandomSampler", "TensorDataset", "WeightedRandomSampler",
           "WorkerInfo", "default_collate_fn", "get_worker_info",
           "random_split"]
