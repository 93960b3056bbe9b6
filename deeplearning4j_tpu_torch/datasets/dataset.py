"""DataSet: one minibatch of features and labels, with their masks
(counterpart of `deeplearning4j_tpu/datasets/dataset.py`): the currency
every iterator yields and `fit` consumes. The arrays are numpy arrays,
or tensors once `DevicePrefetchIterator` has put them on the card.
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

    def _select(self, sel) -> "DataSet":
        md = self.example_metadata
        if md is not None:
            md = (md[sel] if isinstance(sel, slice)
                  else [md[i] for i in sel])
        return DataSet(self.features[sel], _cut(self.labels, sel),
                       _cut(self.features_mask, sel),
                       _cut(self.labels_mask, sel), md)

    def split_test_and_train(self, num_train: int):
        """(the first `num_train` examples, the rest)."""
        return (self._select(slice(None, num_train)),
                self._select(slice(num_train, None)))

    def shuffle(self, seed: Optional[int] = None) -> "DataSet":
        """Permute the examples in place with `default_rng(seed)`."""
        perm = np.random.default_rng(seed).permutation(self.num_examples())
        shuffled = self._select(perm)
        self.features, self.labels = shuffled.features, shuffled.labels
        self.features_mask = shuffled.features_mask
        self.labels_mask = shuffled.labels_mask
        self.example_metadata = shuffled.example_metadata
        return self

    def batch_by(self, batch_size: int) -> List["DataSet"]:
        return [self._select(slice(i, i + batch_size))
                for i in range(0, self.num_examples(), batch_size)]

    @staticmethod
    def merge(datasets) -> "DataSet":
        """The examples of `datasets` in order (a part that some lack is
        None; metadata is dropped, as in JAX)."""
        def cat(xs):
            if any(x is None for x in xs):
                return None
            return np.concatenate(xs, axis=0)
        return DataSet(
            cat([d.features for d in datasets]),
            cat([d.labels for d in datasets]),
            cat([d.features_mask for d in datasets]),
            cat([d.labels_mask for d in datasets]),
        )
