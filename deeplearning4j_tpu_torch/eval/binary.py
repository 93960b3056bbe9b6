"""The port's own copy of `deeplearning4j_tpu/eval/binary.py` (numpy only;
the port imports nothing of the JAX package).

Per-output binary evaluation (multi-label).

Reference: `eval/EvaluationBinary.java`: each output column is an
independent binary problem at threshold 0.5 (configurable); tracks
TP/FP/TN/FN per column with mask support.
"""

from __future__ import annotations

from typing import Optional

import json

import numpy as np

from deeplearning4j_tpu_torch.eval.evaluation import check_payload_type


class EvaluationBinary:
    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold
        self._tp = None
        self._fp = None
        self._tn = None
        self._fn = None

    def _ensure(self, c):
        if self._tp is None:
            z = lambda: np.zeros(c, dtype=np.int64)
            self._tp, self._fp, self._tn, self._fn = z(), z(), z(), z()

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim == 3:
            c = labels.shape[-1]
            labels = labels.reshape(-1, c)
            predictions = predictions.reshape(-1, c)
            if mask is not None:
                m = np.asarray(mask).reshape(-1).astype(bool)
                labels, predictions = labels[m], predictions[m]
        self._ensure(labels.shape[-1])
        pred = predictions >= self.threshold
        lab = labels >= 0.5
        self._tp += np.sum(pred & lab, axis=0)
        self._fp += np.sum(pred & ~lab, axis=0)
        self._tn += np.sum(~pred & ~lab, axis=0)
        self._fn += np.sum(~pred & lab, axis=0)

    def num_labels(self) -> int:
        return 0 if self._tp is None else len(self._tp)

    def accuracy(self, col: int) -> float:
        total = self._tp[col] + self._fp[col] + self._tn[col] + self._fn[col]
        return float((self._tp[col] + self._tn[col]) / total) if total else 0.0

    def precision(self, col: int) -> float:
        denom = self._tp[col] + self._fp[col]
        return float(self._tp[col] / denom) if denom else 0.0

    def recall(self, col: int) -> float:
        denom = self._tp[col] + self._fn[col]
        return float(self._tp[col] / denom) if denom else 0.0

    def f1(self, col: int) -> float:
        p, r = self.precision(col), self.recall(col)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def true_positives(self, col: int) -> int:
        return int(self._tp[col])

    def false_positives(self, col: int) -> int:
        return int(self._fp[col])

    def true_negatives(self, col: int) -> int:
        return int(self._tn[col])

    def false_negatives(self, col: int) -> int:
        return int(self._fn[col])


    # ---- serde + merge (tree-aggregate shape) ----------------------------
    def to_json(self) -> str:
        return json.dumps({
            "format_version": 1, "type": "EvaluationBinary",
            "threshold": self.threshold,
            "tp": None if self._tp is None else self._tp.tolist(),
            "fp": None if self._fp is None else self._fp.tolist(),
            "tn": None if self._tn is None else self._tn.tolist(),
            "fn": None if self._fn is None else self._fn.tolist(),
        })

    @classmethod
    def from_json(cls, s: str) -> "EvaluationBinary":
        d = json.loads(s)
        check_payload_type(d, "EvaluationBinary")
        ev = cls(threshold=d.get("threshold", 0.5))
        if d.get("tp") is not None:
            for f, k in (("_tp", "tp"), ("_fp", "fp"), ("_tn", "tn"),
                         ("_fn", "fn")):
                setattr(ev, f, np.asarray(d[k], np.int64))
        return ev

    def merge(self, other: "EvaluationBinary") -> "EvaluationBinary":
        if other._tp is None:
            return self
        if other.threshold != self.threshold:
            # counts taken at different decision thresholds sum to
            # numbers that correspond to NO threshold — refuse
            raise ValueError(
                f"cannot merge EvaluationBinary at threshold "
                f"{other.threshold} into one at {self.threshold}")
        self._ensure(len(other._tp))
        self._tp += other._tp
        self._fp += other._fp
        self._tn += other._tn
        self._fn += other._fn
        return self

    def stats(self) -> str:
        lines = ["Label   Acc     Precision Recall  F1"]
        for c in range(self.num_labels()):
            lines.append(f"{c:<7} {self.accuracy(c):<7.4f} {self.precision(c):<9.4f} "
                         f"{self.recall(c):<7.4f} {self.f1(c):<7.4f}")
        return "\n".join(lines)
