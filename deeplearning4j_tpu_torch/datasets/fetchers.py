"""Dataset fetchers: MNIST, EMNIST, Iris, CIFAR-10 and LFW iterators
(counterpart of `deeplearning4j_tpu/datasets/fetchers.py`), offline.

A fetcher reads a cached copy under ``$DL4J_TPU_DATA_DIR`` (default
``~/.deeplearning4j_tpu/datasets``, the JAX package's cache, so a copy
either package finds serves both) and otherwise falls back to the JAX
package's deterministic synthetic surrogate, bit for bit (same
generators, same seeds), with the same shapes and classes. The port
never downloads. `is_synthetic` on an iterator (the third value of a
`load_*`) says which path was taken.
"""

from __future__ import annotations

import gzip
import os
import struct
from pathlib import Path

import numpy as np

from deeplearning4j_tpu_torch.datasets.iterator import ArrayDataSetIterator

CACHE_DIR = Path(os.environ.get("DL4J_TPU_DATA_DIR", "~/.deeplearning4j_tpu/datasets")).expanduser()

def _read_idx(path: Path) -> np.ndarray:
    with gzip.open(path, "rb") as f:
        magic = struct.unpack(">HBB", f.read(4))
        ndim = magic[2]
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


def _synthetic_templates(num: int, num_classes: int, seed: int, *,
                         side: int = 28, tpl_seed: int, freq_hi: float):
    """Shared surrogate generator: each class is a fixed low-frequency
    sinusoid template + per-example noise; linearly separable enough
    that small CNNs reach high accuracy, hard enough that accuracy is
    meaningful."""
    rng = np.random.default_rng(seed)
    templates = []
    tpl_rng = np.random.default_rng(tpl_seed)
    yy, xx = np.mgrid[0:side, 0:side].astype(np.float32) / side
    for _ in range(num_classes):
        fx, fy = tpl_rng.uniform(1, freq_hi, 2)
        px, py = tpl_rng.uniform(0, 2 * np.pi, 2)
        tpl = 0.5 + 0.5 * np.sin(2 * np.pi * fx * xx + px) * np.cos(2 * np.pi * fy * yy + py)
        templates.append(tpl.astype(np.float32))
    labels = rng.integers(0, num_classes, size=num)
    images = np.stack([templates[c] for c in labels])
    noise = rng.standard_normal(images.shape, dtype=np.float32)
    images = np.clip(images + 0.25 * noise, 0, 1)
    onehot = np.eye(num_classes, dtype=np.float32)[labels]
    return images.reshape(num, side * side).astype(np.float32), onehot


def _synthetic_digits(num: int, seed: int, side: int = 28):
    """MNIST surrogate (template seed kept stable across refactors)."""
    return _synthetic_templates(num, 10, seed, side=side,
                                tpl_seed=20260729, freq_hi=4)


def load_mnist(train: bool = True, num_examples: int | None = None):
    """Returns (features [N, 784] float32 in [0,1], labels [N,10] one-hot,
    synthetic_flag)."""
    split = "train" if train else "test"
    img_p = CACHE_DIR / "mnist" / f"{split}_images.gz"
    lab_p = CACHE_DIR / "mnist" / f"{split}_labels.gz"
    if img_p.exists() and lab_p.exists():
        try:
            images = _read_idx(img_p).astype(np.float32) / 255.0
            labels = _read_idx(lab_p)
            n = images.shape[0]
            feats = images.reshape(n, -1)
            onehot = np.eye(10, dtype=np.float32)[labels]
            if num_examples:
                feats, onehot = feats[:num_examples], onehot[:num_examples]
            return feats, onehot, False
        except Exception:
            pass
    n = num_examples or (60000 if train else 10000)
    feats, onehot = _synthetic_digits(n, seed=1 if train else 2)
    return feats, onehot, True


class MnistDataSetIterator(ArrayDataSetIterator):
    """Reference `MnistDataSetIterator(batch, train, seed)` — yields
    flattened [batch, 784] features + one-hot labels."""

    def __init__(self, batch_size: int, train: bool = True, seed: int = 123,
                 num_examples: int | None = None, shuffle: bool | None = None,
                 flatten: bool = True):
        """`flatten=False` yields NHWC [B,28,28,1] for conv nets whose
        config declares InputType.convolutional (the reference pairs
        flat output with convolutionalFlat + an auto preprocessor)."""
        feats, labels, synthetic = load_mnist(train, num_examples)
        if not flatten:
            feats = feats.reshape(-1, 28, 28, 1)
        self.is_synthetic = synthetic
        super().__init__(feats, labels, batch_size=batch_size,
                         shuffle=train if shuffle is None else shuffle, seed=seed)


# Fisher's Iris — the real 150-sample dataset is tiny; generated
# surrogate keeps class structure (3 Gaussian clusters in 4-d, one pair
# overlapping like versicolor/virginica).
def load_iris(seed: int = 7):
    rng = np.random.default_rng(seed)
    means = np.array([[5.0, 3.4, 1.5, 0.2], [5.9, 2.8, 4.3, 1.3], [6.6, 3.0, 5.6, 2.0]])
    stds = np.array([[0.35, 0.38, 0.17, 0.10], [0.52, 0.31, 0.47, 0.20], [0.64, 0.32, 0.55, 0.27]])
    feats, labels = [], []
    for c in range(3):
        feats.append(means[c] + stds[c] * rng.standard_normal((50, 4)))
        labels.extend([c] * 50)
    x = np.concatenate(feats).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[np.array(labels)]
    perm = rng.permutation(150)
    return x[perm], y[perm]


class IrisDataSetIterator(ArrayDataSetIterator):
    def __init__(self, batch_size: int = 150, num_examples: int = 150, seed: int = 7):
        x, y = load_iris(seed)
        super().__init__(x[:num_examples], y[:num_examples], batch_size=batch_size)


# ---------------------------------------------------------------- EMNIST
# Reference `EmnistFetcher`/`EmnistDataSetIterator`: EMNIST splits
# extend MNIST with letters; the surrogate generalizes _synthetic_digits
# to `num_classes` templates.
_EMNIST_CLASSES = {"letters": 26, "digits": 10, "balanced": 47,
                   "byclass": 62, "bymerge": 47, "mnist": 10}


def _synthetic_classes(num: int, num_classes: int, seed: int, side: int = 28):
    return _synthetic_templates(num, num_classes, seed, side=side,
                                tpl_seed=20260730 + num_classes, freq_hi=5)


def load_emnist(split: str = "balanced", train: bool = True,
                num_examples: int | None = None):
    """(features [N,784], one-hot labels, synthetic_flag)."""
    if split not in _EMNIST_CLASSES:
        raise ValueError(f"Unknown EMNIST split {split!r}: {sorted(_EMNIST_CLASSES)}")
    nc = _EMNIST_CLASSES[split]
    n = num_examples or (10000 if train else 2000)
    feats, onehot = _synthetic_classes(n, nc, seed=11 if train else 12)
    return feats, onehot, True


class EmnistDataSetIterator(ArrayDataSetIterator):
    """Reference `EmnistDataSetIterator(dataset, batch, train)`."""

    def __init__(self, split: str = "balanced", batch_size: int = 32,
                 train: bool = True, num_examples: int | None = None,
                 seed: int = 123):
        feats, labels, synthetic = load_emnist(split, train, num_examples)
        self.is_synthetic = synthetic
        self.num_classes = _EMNIST_CLASSES[split]
        super().__init__(feats, labels, batch_size=batch_size,
                         shuffle=train, seed=seed)


# ---------------------------------------------------------------- CIFAR-10
def load_cifar10(train: bool = True, num_examples: int | None = None):
    """(features [N,32,32,3] in [0,1] NHWC, one-hot labels,
    synthetic_flag). Surrogate: per-class color+texture templates."""
    n = num_examples or (50000 if train else 10000)
    rng = np.random.default_rng(21 if train else 22)
    tpl_rng = np.random.default_rng(20260731)
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32) / 32
    templates = []
    for _ in range(10):
        chans = []
        for _c in range(3):
            fx, fy = tpl_rng.uniform(0.5, 4, 2)
            px, py = tpl_rng.uniform(0, 2 * np.pi, 2)
            chans.append(0.5 + 0.5 * np.sin(2 * np.pi * fx * xx + px) *
                         np.cos(2 * np.pi * fy * yy + py))
        templates.append(np.stack(chans, -1).astype(np.float32))
    labels = rng.integers(0, 10, size=n)
    images = np.stack([templates[c] for c in labels])
    noise = rng.standard_normal(images.shape, dtype=np.float32)
    images = np.clip(images + 0.2 * noise, 0, 1)
    return images, np.eye(10, dtype=np.float32)[labels], True


class Cifar10DataSetIterator(ArrayDataSetIterator):
    """Reference `CifarDataSetIterator` — NHWC [B,32,32,3] batches."""

    def __init__(self, batch_size: int = 32, train: bool = True,
                 num_examples: int | None = None, seed: int = 123):
        feats, labels, synthetic = load_cifar10(train, num_examples)
        self.is_synthetic = synthetic
        super().__init__(feats, labels, batch_size=batch_size,
                         shuffle=train, seed=seed)


def load_lfw(num_examples: int | None = None, num_labels: int = 5749,
             use_subset: bool = True, image_size: int = 64):
    """LFW faces (reference `LFWDataSetIterator.java` / `LFWFetcher`:
    13,233 images, 5,749 people; `use_subset` = the "lfw-a" subset).
    Returns ([N, S, S, 3] float32 NHWC, one-hot labels, synthetic_flag).
    Surrogate when offline: per-identity face-like templates (oval +
    eye/mouth blobs at identity-specific offsets) + noise."""
    n_ids = min(num_labels, 40 if use_subset else 5749)
    n = num_examples or (1054 if use_subset else 13233)
    rng = np.random.default_rng(31)
    tpl_rng = np.random.default_rng(20260801)
    s = image_size
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
    templates = []
    for _ in range(n_ids):
        cx, cy = tpl_rng.uniform(0.4, 0.6, 2)
        rx, ry = tpl_rng.uniform(0.22, 0.3, 2)
        face = np.clip(1.2 - (((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2), 0, 1)
        for bx, by in ((cx - rx / 2, cy - ry / 3), (cx + rx / 2, cy - ry / 3),
                       (cx, cy + ry / 2)):
            face -= 0.5 * np.exp(-(((xx - bx) ** 2 + (yy - by) ** 2)
                                   / tpl_rng.uniform(0.001, 0.004)))
        tone = tpl_rng.uniform(0.5, 1.0, 3).astype(np.float32)
        templates.append(np.clip(face[..., None] * tone, 0, 1).astype(np.float32))
    labels = rng.integers(0, n_ids, size=n)
    images = np.stack([templates[c] for c in labels])
    noise = rng.standard_normal(images.shape, dtype=np.float32)
    images = np.clip(images + 0.1 * noise, 0, 1)
    return images, np.eye(n_ids, dtype=np.float32)[labels], True


class LFWDataSetIterator(ArrayDataSetIterator):
    """Reference `datasets/iterator/impl/LFWDataSetIterator.java`."""

    def __init__(self, batch_size: int = 32, num_examples: int | None = None,
                 num_labels: int = 5749, use_subset: bool = True,
                 image_size: int = 64, train: bool = True, seed: int = 123):
        feats, labels, synthetic = load_lfw(num_examples, num_labels,
                                            use_subset, image_size)
        self.is_synthetic = synthetic
        super().__init__(feats, labels, batch_size=batch_size,
                         shuffle=train, seed=seed)
