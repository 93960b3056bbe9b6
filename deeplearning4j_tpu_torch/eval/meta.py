"""The port's own copy of `deeplearning4j_tpu/eval/meta.py` (numpy only;
the port imports nothing of the JAX package).

Per-example prediction metadata tracking.

Reference: `eval/meta/Prediction.java` + the
`Evaluation.eval(labels, out, recordMetaData)` overload — when the data
pipeline carries record metadata (e.g. source file + line of each
example), evaluation keeps one `Prediction` per example so
misclassifications can be traced back to their records
(`getPredictionErrors()` etc., `EvaluationTools` error inspection).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List


@dataclasses.dataclass
class Prediction:
    """Reference `Prediction.java`: (actual, predicted, record metadata)."""

    actual_class: int
    predicted_class: int
    record_metadata: Any = None

    def __repr__(self):
        return (f"Prediction(actual={self.actual_class}, "
                f"predicted={self.predicted_class}, "
                f"record_metadata={self.record_metadata!r})")


class PredictionLedger:
    """Accumulates Predictions across eval() batches (mixed into
    Evaluation)."""

    def __init__(self):
        self.predictions: List[Prediction] = []

    def record(self, actual, predicted, metadata_list):
        for a, p, m in zip(actual, predicted, metadata_list):
            self.predictions.append(Prediction(int(a), int(p), m))

    def get_prediction_errors(self) -> List[Prediction]:
        """Reference `getPredictionErrors()`."""
        return [p for p in self.predictions
                if p.actual_class != p.predicted_class]

    def get_predictions_by_actual_class(self, cls: int) -> List[Prediction]:
        return [p for p in self.predictions if p.actual_class == cls]

    def get_predictions_by_predicted_class(self, cls: int) -> List[Prediction]:
        return [p for p in self.predictions if p.predicted_class == cls]

    def get_predictions(self, actual: int, predicted: int) -> List[Prediction]:
        """Reference `getPredictions(actual, predicted)` — one confusion
        matrix cell's examples."""
        return [p for p in self.predictions
                if p.actual_class == actual and p.predicted_class == predicted]
