"""The port's own copy of `deeplearning4j_tpu/eval/curves.py` (numpy only;
the port imports nothing of the JAX package).

Serializable evaluation curves.

Reference: `eval/curves/` — `RocCurve.java` (threshold/fpr/tpr triples,
JSON round-trip, point queries), `PrecisionRecallCurve.java`
(threshold/precision/recall + point-at-threshold helpers),
`Histogram.java`, `ReliabilityDiagram.java`. These are the wire format
that lets a curve computed during training be stored, shipped to the
UI, and re-plotted without the raw scores.
"""

from __future__ import annotations

import json
from typing import List, Optional

import numpy as np


class BaseCurve:
    _fields: tuple = ()

    def to_dict(self) -> dict:
        out = {"type": type(self).__name__}
        for f in self._fields:
            v = getattr(self, f)
            out[f] = v.tolist() if isinstance(v, np.ndarray) else v
        return out

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_json(cls, s: str) -> "BaseCurve":
        d = json.loads(s)
        if d.pop("type", cls.__name__) != cls.__name__:
            raise ValueError(f"not a serialized {cls.__name__}")
        return cls(**d)

    def __eq__(self, other):
        if type(self) is not type(other):
            return NotImplemented
        for f in self._fields:
            a, b = getattr(self, f), getattr(other, f)
            if isinstance(a, np.ndarray):
                if not np.allclose(a, np.asarray(b)):
                    return False
            elif a != b:
                return False
        return True


class RocCurve(BaseCurve):
    """Reference `RocCurve.java`: parallel threshold/fpr/tpr arrays."""

    _fields = ("thresholds", "fpr", "tpr")

    def __init__(self, thresholds, fpr, tpr):
        self.thresholds = np.asarray(thresholds, np.float64)
        self.fpr = np.asarray(fpr, np.float64)
        self.tpr = np.asarray(tpr, np.float64)

    def num_points(self) -> int:
        return len(self.fpr)

    def get_threshold(self, i) -> float:
        return float(self.thresholds[i])

    def get_false_positive_rate(self, i) -> float:
        return float(self.fpr[i])

    def get_true_positive_rate(self, i) -> float:
        return float(self.tpr[i])

    def calculate_auc(self) -> float:
        return float(np.trapezoid(self.tpr, self.fpr))


class PrecisionRecallCurve(BaseCurve):
    """Reference `PrecisionRecallCurve.java` incl. the point queries
    used to pick an operating threshold."""

    _fields = ("thresholds", "precision", "recall")

    def __init__(self, thresholds, precision, recall):
        self.thresholds = np.asarray(thresholds, np.float64)
        self.precision = np.asarray(precision, np.float64)
        self.recall = np.asarray(recall, np.float64)

    def num_points(self) -> int:
        return len(self.precision)

    def calculate_auprc(self) -> float:
        order = np.argsort(self.recall)
        return float(np.trapezoid(self.precision[order], self.recall[order]))

    def get_point_at_threshold(self, threshold: float):
        """(threshold, precision, recall) at the smallest stored
        threshold ≥ requested — never an operating point below the
        requested threshold (reference `getPointAtThreshold`); falls
        back to the highest stored threshold when none qualifies."""
        ok = np.nonzero(self.thresholds >= threshold)[0]
        if len(ok) == 0:
            i = int(np.argmax(self.thresholds))
        else:
            i = ok[int(np.argmin(self.thresholds[ok]))]
        return (float(self.thresholds[i]), float(self.precision[i]),
                float(self.recall[i]))

    def get_point_at_precision(self, min_precision: float):
        """Best-recall point with precision ≥ min_precision."""
        ok = np.nonzero(self.precision >= min_precision)[0]
        if len(ok) == 0:   # fall back to max-precision point
            i = int(np.argmax(self.precision))
        else:
            i = ok[int(np.argmax(self.recall[ok]))]
        return (float(self.thresholds[i]), float(self.precision[i]),
                float(self.recall[i]))

    def get_point_at_recall(self, min_recall: float):
        """Best-precision point with recall ≥ min_recall."""
        ok = np.nonzero(self.recall >= min_recall)[0]
        if len(ok) == 0:
            i = int(np.argmax(self.recall))
        else:
            i = ok[int(np.argmax(self.precision[ok]))]
        return (float(self.thresholds[i]), float(self.precision[i]),
                float(self.recall[i]))


class Histogram(BaseCurve):
    """Reference `Histogram.java`: titled, uniformly-binned counts."""

    _fields = ("title", "lower", "upper", "bin_counts")

    def __init__(self, title, lower, upper, bin_counts):
        self.title = title
        self.lower = float(lower)
        self.upper = float(upper)
        self.bin_counts = np.asarray(bin_counts, np.int64)

    def num_bins(self) -> int:
        return len(self.bin_counts)

    def bin_edges(self) -> np.ndarray:
        return np.linspace(self.lower, self.upper, len(self.bin_counts) + 1)


class ReliabilityDiagram(BaseCurve):
    """Reference `ReliabilityDiagram.java`: mean predicted probability
    vs observed frequency per calibration bin."""

    _fields = ("title", "mean_predicted", "fraction_positives")

    def __init__(self, title, mean_predicted, fraction_positives):
        self.title = title
        self.mean_predicted = np.asarray(mean_predicted, np.float64)
        self.fraction_positives = np.asarray(fraction_positives, np.float64)

    def num_points(self) -> int:
        return len(self.mean_predicted)
