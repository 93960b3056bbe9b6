"""Score calculators (counterpart of
`deeplearning4j_tpu/earlystopping/scorecalc.py`): the loss over a
held-out iterator, and 1 - accuracy."""

from __future__ import annotations

from deeplearning4j_tpu_torch.datasets.iterator import as_iterator


class DataSetLossCalculator:
    def __init__(self, iterator, average: bool = True):
        self.iterator = as_iterator(iterator)
        self.average = average

    def calculate_score(self, model) -> float:
        total, n = 0.0, 0
        self.iterator.reset()
        for ds in self.iterator:
            b = ds.num_examples()
            total += model.score(ds) * (b if self.average else 1.0)
            n += b if self.average else 1
        return total / max(n, 1)


class ClassificationScoreCalculator:
    """Score = 1 - accuracy, so lower is better throughout."""

    def __init__(self, iterator):
        self.iterator = as_iterator(iterator)

    def calculate_score(self, model) -> float:
        return 1.0 - model.evaluate(self.iterator).accuracy()
