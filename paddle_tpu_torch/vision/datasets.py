"""Vision datasets: port of paddle_tpu/vision/datasets.py (reference:
python/paddle/vision/datasets/). Without data files each dataset
synthesizes the reference's deterministic data (same recipes, same
seeds), so a training loop and its tests run offline and draw the same
samples on both sides. Samples are numpy; the DataLoader's collate makes
the Tensors."""
from __future__ import annotations

import gzip
import hashlib
import os
import struct
import warnings

import numpy as np

from ..io import Dataset


class MNIST(Dataset):
    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend=None):
        self.mode = mode
        self.transform = transform
        images = labels = None
        if image_path and os.path.exists(image_path):
            with gzip.open(image_path, "rb") as f:
                magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
                images = np.frombuffer(f.read(), dtype=np.uint8).reshape(
                    n, rows, cols)
        if label_path and os.path.exists(label_path):
            with gzip.open(label_path, "rb") as f:
                magic, n = struct.unpack(">II", f.read(8))
                labels = np.frombuffer(f.read(), dtype=np.uint8)
        if images is None:
            # deterministic synthetic digits: class-dependent blob patterns
            rng = np.random.default_rng(42 if mode == "train" else 43)
            n = 2048 if mode == "train" else 512
            labels = rng.integers(0, 10, n).astype(np.int64)
            images = np.zeros((n, 28, 28), dtype=np.uint8)
            for i, lab in enumerate(labels):
                r, c = divmod(int(lab), 4)
                images[i, 3 + r * 6:9 + r * 6, 3 + c * 6:9 + c * 6] = 255
                images[i] += rng.integers(0, 30, (28, 28)).astype(np.uint8)
        self.images = images
        self.labels = labels.astype(np.int64)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = (img.astype(np.float32) / 255.0)[None]
        return img, np.asarray(self.labels[idx])

    def __len__(self):
        return len(self.images)


FashionMNIST = MNIST


class Cifar10(Dataset):
    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        self.transform = transform
        rng = np.random.default_rng(7 if mode == "train" else 8)
        n = 2048 if mode == "train" else 512
        self.labels = rng.integers(0, 10, n).astype(np.int64)
        base = rng.normal(0, 1, (10, 3, 32, 32)).astype(np.float32)
        noise = rng.normal(0, 0.5, (n, 3, 32, 32)).astype(np.float32)
        self.images = base[self.labels] + noise

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(np.transpose(img, (1, 2, 0)))
        return img, np.asarray(self.labels[idx])

    def __len__(self):
        return len(self.images)


class Cifar100(Cifar10):
    pass


class DatasetFolder(Dataset):
    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        self.samples = []
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d))) \
            if os.path.isdir(root) else []
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        for c in classes:
            for fn in sorted(os.listdir(os.path.join(root, c))):
                self.samples.append((os.path.join(root, c, fn),
                                     self.class_to_idx[c]))

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        img = np.asarray(_load_image(path))
        if self.transform:
            img = self.transform(img)
        return img, target

    def __len__(self):
        return len(self.samples)


ImageFolder = DatasetFolder


def _load_image(path):
    try:
        from PIL import Image
        return Image.open(path).convert("RGB")
    except ImportError:
        raise RuntimeError("PIL not available for image loading")


class Flowers(Dataset):
    """Reference: vision/datasets/flowers.py — 102-category flowers.
    Synthetic offline stand-in, the reference's paddle.dataset.flowers
    stream (0-based labels per the reference loader)."""

    def __init__(self, mode="train", transform=None, backend=None,
                 download=True):
        n = {"train": 256, "valid": 64, "test": 64}[mode]
        self.data = list(_flowers(mode, n))
        self.transform = transform

    def __getitem__(self, idx):
        img, label = self.data[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return len(self.data)


class VOC2012(Dataset):
    """Reference: vision/datasets/voc2012.py — segmentation pairs.
    Synthetic offline stand-in, the reference's paddle.dataset.voc2012
    stream."""

    def __init__(self, mode="train", transform=None, backend=None,
                 download=True):
        tag, n = {"train": ("train", 128), "valid": ("val", 32),
                  "test": ("test", 32)}[mode]
        self.data = list(_voc2012(tag, n))
        self.transform = transform

    def __getitem__(self, idx):
        img, label = self.data[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return len(self.data)


# ---------------------------------------------------------------------------
# the reference's synthetic paddle.dataset streams (dataset/common.py,
# flowers.py, voc2012.py): one numpy generator per (module, split), seeded
# from the sha256 of "module/split"
# ---------------------------------------------------------------------------
_warned: set = set()


def _synthetic_rng(module_name, tag):
    if module_name not in _warned:
        _warned.add(module_name)
        warnings.warn(f"vision.datasets: no {module_name} data files; "
                      "serving a deterministic SYNTHETIC stream with the "
                      "real shapes", UserWarning)
    seed = int.from_bytes(hashlib.sha256(
        f"{module_name}/{tag}".encode()).digest()[:4], "little")
    return np.random.default_rng(seed)


def _flowers(tag, n, n_classes=102):
    rng = _synthetic_rng("flowers", tag)
    for _ in range(n):
        label = int(rng.integers(0, n_classes))
        img = rng.normal(0.02 * (label % 16), 0.3,
                         (3, 224, 224)).astype(np.float32)
        yield np.clip(img + 0.5, 0, 1), label


def _voc2012(tag, n, n_classes=21, size=128):
    rng = _synthetic_rng("voc2012", tag)
    for _ in range(n):
        img = np.clip(rng.normal(0.5, 0.25, (3, size, size)), 0,
                      1).astype(np.float32)
        mask = np.zeros((size, size), np.int32)
        for _ in range(int(rng.integers(1, 4))):
            cls = int(rng.integers(1, n_classes))
            r0, c0 = rng.integers(0, size - 32), rng.integers(0, size - 32)
            h, w = rng.integers(16, 48), rng.integers(16, 48)
            mask[r0:r0 + h, c0:c0 + w] = cls
            img[:, r0:r0 + h, c0:c0 + w] += 0.05 * cls
        yield np.clip(img, 0, 1), mask
