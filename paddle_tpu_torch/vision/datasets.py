"""Vision datasets: counterpart of ``paddle_tpu/vision/datasets.py``.

Nothing is downloaded: ``download=True`` raises. Each dataset reads
pre-downloaded files from disk where the JAX one does (MNIST's idx
files, ``DatasetFolder``'s tree of ``.npy`` files) and otherwise makes
deterministic synthetic images from numpy ``RandomState`` by the JAX
package's recipe (class templates plus noise), so a sample is bit-equal
to the JAX package's. Samples are numpy arrays; ``io.DataLoader``
collates them into tensors.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ..io.dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100", "Flowers", "DatasetFolder"]


def _no_download(download: bool) -> None:
    if download:
        raise RuntimeError(
            "download=True: nothing is downloaded; pass the paths of "
            "pre-downloaded files, or none for the synthetic samples")


class _SyntheticClassification(Dataset):
    """Deterministic synthetic images: class-dependent patterns + noise, so
    small models genuinely learn (loss decreases) without real data."""

    def __init__(self, num_samples, image_shape, num_classes, seed=0,
                 transform=None):
        self.num_samples = num_samples
        self.image_shape = image_shape
        self.num_classes = num_classes
        self.transform = transform
        rng = np.random.RandomState(seed)
        # one fixed template per class
        self.templates = rng.uniform(0.0, 1.0,
                                     (num_classes,) + image_shape).astype(np.float32)
        self.labels = rng.randint(0, num_classes, num_samples).astype(np.int64)
        self.noise_seeds = rng.randint(0, 2 ** 31 - 1, num_samples)

    def __getitem__(self, idx):
        label = self.labels[idx]
        rng = np.random.RandomState(self.noise_seeds[idx])
        img = self.templates[label] + 0.3 * rng.randn(*self.image_shape).astype(np.float32)
        img = img.astype(np.float32)
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return self.num_samples


class MNIST(Dataset):
    """reference: python/paddle/vision/datasets/mnist.py.

    Loads idx-format files when `image_path`/`label_path` exist; otherwise
    falls back to the synthetic generator (no-egress environment)."""

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=False, backend=None,
                 num_synthetic=2048):
        _no_download(download)
        self.mode = mode
        self.transform = transform
        if image_path and label_path and os.path.exists(image_path):
            self.images, self.labels = self._load_idx(image_path, label_path)
        else:
            n = num_synthetic if mode == "train" else max(num_synthetic // 4, 256)
            syn = _SyntheticClassification(n, (1, 28, 28), 10,
                                           seed=0 if mode == "train" else 1)
            self._syn = syn
            self.images = None
            self.labels = syn.labels

    @staticmethod
    def _load_idx(image_path, label_path):
        with gzip.open(image_path, "rb") as f:
            _, n, rows, cols = struct.unpack(">IIII", f.read(16))
            images = np.frombuffer(f.read(), np.uint8).reshape(n, 1, rows, cols)
        with gzip.open(label_path, "rb") as f:
            _, n = struct.unpack(">II", f.read(8))
            labels = np.frombuffer(f.read(), np.uint8).astype(np.int64)
        return images.astype(np.float32) / 255.0, labels

    def __getitem__(self, idx):
        if self.images is None:
            img, label = self._syn[idx]
        else:
            img, label = self.images[idx], self.labels[idx]
            if self.transform is not None:
                img = self.transform(img)
        return img, np.asarray([label], np.int64)

    def __len__(self):
        return len(self.labels)


class FashionMNIST(MNIST):
    pass


class Cifar10(Dataset):
    def __init__(self, data_file=None, mode="train", transform=None,
                 download=False, backend=None, num_synthetic=2048):
        _no_download(download)
        self.transform = transform
        n = num_synthetic if mode == "train" else max(num_synthetic // 4, 256)
        self._syn = _SyntheticClassification(n, (3, 32, 32), 10,
                                             seed=2 if mode == "train" else 3,
                                             transform=transform)

    def __getitem__(self, idx):
        img, label = self._syn[idx]
        return img, np.int64(label)

    def __len__(self):
        return len(self._syn)


class Cifar100(Cifar10):
    def __init__(self, data_file=None, mode="train", transform=None,
                 download=False, backend=None, num_synthetic=2048):
        _no_download(download)
        self.transform = transform
        n = num_synthetic if mode == "train" else max(num_synthetic // 4, 256)
        self._syn = _SyntheticClassification(n, (3, 32, 32), 100,
                                             seed=4 if mode == "train" else 5,
                                             transform=transform)


class Flowers(Cifar10):
    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=False, backend=None,
                 num_synthetic=1024):
        _no_download(download)
        self.transform = transform
        n = num_synthetic
        self._syn = _SyntheticClassification(n, (3, 64, 64), 102, seed=6,
                                             transform=transform)


class DatasetFolder(Dataset):
    """ImageFolder-style dataset over a directory tree of class subdirs."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        self.loader = loader or self._default_loader
        extensions = extensions or (".npy",)
        self.samples = []
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        for c in classes:
            cdir = os.path.join(root, c)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(extensions):
                    self.samples.append((os.path.join(cdir, fname),
                                         self.class_to_idx[c]))

    @staticmethod
    def _default_loader(path):
        return np.load(path)

    def __getitem__(self, idx):
        path, label = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return len(self.samples)
