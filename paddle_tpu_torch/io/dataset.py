"""Datasets (reference: python/paddle/fluid/dataloader/dataset.py).

Counterpart of ``paddle_tpu/io/dataset.py``, class for class.
``TensorDataset`` takes torch tensors or numpy arrays and yields torch
tensors; ``random_split`` draws its permutation from numpy's global
generator, as the JAX package's does, so after ``np.random.seed(s)``
both packages split alike."""

from __future__ import annotations

import bisect
import numpy as np
import torch


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = [t if isinstance(t, torch.Tensor)
                        else torch.as_tensor(np.asarray(t)) for t in tensors]
        n = len(self.tensors[0])
        if any(len(t) != n for t in self.tensors):
            raise ValueError("TensorDataset: every tensor needs the same "
                             "first dimension")

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return len(self.tensors[0])


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        n = len(self.datasets[0])
        if any(len(d) != n for d in self.datasets):
            raise ValueError("ComposeDataset: every dataset needs the "
                             "same length")

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            sample = d[idx]
            out.extend(sample if isinstance(sample, (tuple, list)) else [sample])
        return tuple(out)

    def __len__(self):
        return len(self.datasets[0])


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx = len(self) + idx
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        sample_idx = idx if ds_idx == 0 else idx - self.cumulative_sizes[ds_idx - 1]
        return self.datasets[ds_idx][sample_idx]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    total = sum(lengths)
    if total != len(dataset):
        raise ValueError(f"random_split: lengths sum to {total}, the "
                         f"dataset holds {len(dataset)}")
    perm = np.random.permutation(total)
    out, offset = [], 0
    for ln in lengths:
        out.append(Subset(dataset, perm[offset:offset + ln].tolist()))
        offset += ln
    return out


RandomSplit = random_split
