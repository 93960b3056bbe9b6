"""Minibatch iteration for `fit` and `evaluate` (counterpart of
`deeplearning4j_tpu/datasets/iterator.py`: `ListDataSetIterator` :62,
`ArrayDataSetIterator` :82, `as_iterator` :418; `DataSet` from
`datasets/dataset.py` :20-80). Cursors and the other iterators are a
later slice.

Batches come in order, the partial tail batch included, each with its
slice of the features and label masks. With `shuffle=True` every pass
permutes the example indices with one `np.random.default_rng(seed)`
stream created with the iterator (seed 123 by default), so a `fit` of
several epochs draws the same permutations as the JAX `fit`. A
`DataSet` given to `fit` is cut into batches in order, never shuffled,
as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


def _cut(a, sel):
    return None if a is None else a[sel]


@dataclasses.dataclass
class DataSet:
    features: np.ndarray
    labels: Optional[np.ndarray] = None
    features_mask: Optional[np.ndarray] = None
    labels_mask: Optional[np.ndarray] = None
    # per-example record metadata (a list of num_examples), or None
    example_metadata: Optional[list] = None

    def num_examples(self) -> int:
        return int(np.shape(self.features)[0])

    def batch_by(self, batch_size: int) -> List["DataSet"]:
        md = self.example_metadata
        return [DataSet(self.features[i:i + batch_size],
                        _cut(self.labels, slice(i, i + batch_size)),
                        _cut(self.features_mask, slice(i, i + batch_size)),
                        _cut(self.labels_mask, slice(i, i + batch_size)),
                        None if md is None else md[i:i + batch_size])
                for i in range(0, self.num_examples(), batch_size)]


class ListDataSetIterator:
    """Iterate a list of `DataSet`s as they are."""

    def __init__(self, datasets: List[DataSet]):
        self._datasets = list(datasets)

    def __iter__(self):
        return iter(self._datasets)


class ArrayDataSetIterator:
    """Minibatches over (features, labels) arrays and their masks,
    optionally shuffled each pass."""

    def __init__(self, features, labels=None, batch_size: int = 32,
                 shuffle: bool = False, seed: int = 123,
                 features_mask=None, labels_mask=None):
        self.features = np.asarray(features)
        self.labels = None if labels is None else np.asarray(labels)
        self.features_mask = (None if features_mask is None
                              else np.asarray(features_mask))
        self.labels_mask = (None if labels_mask is None
                            else np.asarray(labels_mask))
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
            yield DataSet(self.features[sel], _cut(self.labels, sel),
                          _cut(self.features_mask, sel),
                          _cut(self.labels_mask, sel))


def as_iterator(data, labels=None, batch_size: int = 32, **kw):
    """Coerce `fit()`-style inputs into an iterable of `DataSet`s: an
    iterator passes as it is, a `DataSet` is cut into batches in order
    (its masks too), a list of `DataSet`s is taken as the batches, and
    arrays go through `ArrayDataSetIterator`."""
    if isinstance(data, (ArrayDataSetIterator, ListDataSetIterator)):
        return data
    if isinstance(data, DataSet):
        return ListDataSetIterator(data.batch_by(batch_size))
    if (isinstance(data, (list, tuple)) and data
            and isinstance(data[0], DataSet)):
        return ListDataSetIterator(data)
    return ArrayDataSetIterator(data, labels, batch_size=batch_size, **kw)
