"""MultiDataSet: a minibatch with several feature and label arrays, for
a ComputationGraph with several inputs or outputs (counterpart of
`deeplearning4j_tpu/datasets/multidataset.py`)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class MultiDataSet:
    features: List[np.ndarray]
    labels: List[np.ndarray]
    features_masks: Optional[List[Optional[np.ndarray]]] = None
    labels_masks: Optional[List[Optional[np.ndarray]]] = None

    def num_examples(self) -> int:
        return int(np.shape(self.features[0])[0])


class MultiDataSetIterator:
    """A resettable iterable of `MultiDataSet`s."""

    def __init__(self, datasets: List[MultiDataSet]):
        self._datasets = list(datasets)

    def __iter__(self):
        return iter(self._datasets)

    def reset(self):
        pass
