"""Minibatch iteration for `fit` (counterpart of
`deeplearning4j_tpu/datasets/iterator.py`: `ArrayDataSetIterator` :82,
`as_iterator` :418; `DataSet` from `datasets/dataset.py`). Only the
array iterator `fit` builds is ported; masks, cursors and the other
iterators are a later slice.

Batches come in order, the partial tail batch included. With
`shuffle=True` every pass permutes the example indices with one
`np.random.default_rng(seed)` stream created with the iterator (seed
123 by default), so a `fit` of several epochs draws the same
permutations as the JAX `fit`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class DataSet:
    features: np.ndarray
    labels: Optional[np.ndarray] = None
    features_mask: Optional[np.ndarray] = None
    labels_mask: Optional[np.ndarray] = None


class ArrayDataSetIterator:
    """Minibatches over (features, labels) arrays, optionally shuffled
    each pass."""

    def __init__(self, features, labels=None, batch_size: int = 32,
                 shuffle: bool = False, seed: int = 123):
        self.features = np.asarray(features)
        self.labels = None if labels is None else np.asarray(labels)
        if int(batch_size) < 1:
            raise ValueError(f"batch_size must be >= 1; got {batch_size}")
        self._batch = int(batch_size)
        self._shuffle = shuffle
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        n = self.features.shape[0]
        idx = np.arange(n)
        if self._shuffle:
            self._rng.shuffle(idx)
        for i in range(0, n, self._batch):
            sel = idx[i:i + self._batch]
            yield DataSet(self.features[sel],
                          None if self.labels is None else self.labels[sel])

def as_iterator(data, labels=None, batch_size: int = 32, **kw):
    """Coerce `fit()`-style inputs (an iterator, a `DataSet`, or feature
    and label arrays) into an iterator of `DataSet`s. Masks are not
    ported: a `DataSet` that carries one is refused."""
    if isinstance(data, ArrayDataSetIterator):
        return data
    if isinstance(data, DataSet):
        if data.features_mask is not None or data.labels_mask is not None:
            raise NotImplementedError("masks are not ported")
        data, labels = data.features, data.labels
    return ArrayDataSetIterator(data, labels, batch_size=batch_size, **kw)
