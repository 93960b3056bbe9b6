"""The port's own copy of `deeplearning4j_tpu/eval/roc.py` (numpy only;
the port imports nothing of the JAX package).

ROC / AUC evaluation.

Reference: `eval/ROC.java` (exact mode when thresholdSteps==0, else
thresholded), `ROCBinary.java` (per-output binary), `ROCMultiClass.java`
(one-vs-all per class). AUROC via trapezoidal rule on the exact curve;
AUPRC likewise.
"""

from __future__ import annotations

from typing import List, Optional

import json

import numpy as np

from deeplearning4j_tpu_torch.eval.evaluation import check_payload_type


def _binary_roc_points(labels: np.ndarray, probs: np.ndarray):
    order = np.argsort(-probs, kind="stable")
    labels = labels[order]
    tp = np.cumsum(labels)
    fp = np.cumsum(1 - labels)
    total_pos = tp[-1] if len(tp) else 0
    total_neg = fp[-1] if len(fp) else 0
    tpr = tp / total_pos if total_pos else np.zeros_like(tp, dtype=np.float64)
    fpr = fp / total_neg if total_neg else np.zeros_like(fp, dtype=np.float64)
    return np.concatenate([[0.0], fpr]), np.concatenate([[0.0], tpr])


def _auc(x, y):
    return float(np.trapezoid(y, x))


class ROC:
    """Binary ROC. Accumulates raw (label, score) pairs → exact curve
    (reference exact mode, thresholdSteps=0)."""

    def __init__(self, threshold_steps: int = 0):
        self.threshold_steps = threshold_steps
        self._labels: List[np.ndarray] = []
        self._probs: List[np.ndarray] = []

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
        if labels.ndim == 2 and labels.shape[-1] == 2:
            # [P(class0), P(class1)] convention: positive = column 1
            labels = labels[:, 1]
            predictions = predictions[:, 1]
        else:
            labels = labels.reshape(-1)
            predictions = predictions.reshape(-1)
        self._labels.append(labels.astype(np.float64))
        self._probs.append(predictions.astype(np.float64))

    def _collect(self):
        return np.concatenate(self._labels), np.concatenate(self._probs)

    def calculate_auc(self) -> float:
        labels, probs = self._collect()
        fpr, tpr = _binary_roc_points(labels, probs)
        return _auc(fpr, tpr)

    def calculate_auprc(self) -> float:
        labels, probs = self._collect()
        order = np.argsort(-probs, kind="stable")
        labels = labels[order]
        tp = np.cumsum(labels)
        k = np.arange(1, len(labels) + 1)
        precision = tp / k
        recall = tp / tp[-1] if tp[-1] else np.zeros_like(tp, dtype=np.float64)
        return _auc(np.concatenate([[0.0], recall]), np.concatenate([[1.0], precision]))

    def get_roc_curve(self):
        labels, probs = self._collect()
        return _binary_roc_points(labels, probs)

    def get_roc_curve_object(self):
        """Serializable curve (reference `ROC.getRocCurve()` ->
        `RocCurve.java`): thresholds descending with the (0,0) anchor at
        threshold 1+max."""
        from deeplearning4j_tpu_torch.eval.curves import RocCurve
        labels, probs = self._collect()
        fpr, tpr = _binary_roc_points(labels, probs)
        order = np.argsort(-probs, kind="stable")
        thresholds = np.concatenate([[1.0 if len(probs) == 0
                                      else float(probs[order[0]]) + 1.0],
                                     probs[order]])
        return RocCurve(thresholds, fpr, tpr)

    def get_precision_recall_curve(self):
        """Reference `ROC.getPrecisionRecallCurve()` ->
        `PrecisionRecallCurve.java`."""
        from deeplearning4j_tpu_torch.eval.curves import PrecisionRecallCurve
        labels, probs = self._collect()
        order = np.argsort(-probs, kind="stable")
        lab = labels[order]
        tp = np.cumsum(lab)
        n = np.arange(1, len(lab) + 1)
        precision = tp / n
        total_pos = tp[-1] if len(tp) else 0
        recall = (tp / total_pos if total_pos
                  else np.zeros_like(tp, dtype=np.float64))
        return PrecisionRecallCurve(probs[order], precision, recall)



    # ---- serde + merge (exact mode stores raw scores, so serialization
    # carries them — the reference's exact-mode ROC does the same via
    # its stored prediction arrays)
    def to_dict(self) -> dict:
        labels, probs = (self._collect() if self._labels
                         else (np.zeros(0), np.zeros(0)))
        return {"format_version": 1, "type": "ROC",
                "threshold_steps": self.threshold_steps,
                "labels": labels.tolist(), "probs": probs.tolist()}

    @classmethod
    def from_dict(cls, d: dict) -> "ROC":
        check_payload_type(d, "ROC")
        roc = cls(threshold_steps=d.get("threshold_steps", 0))
        if d.get("labels"):
            roc._labels.append(np.asarray(d["labels"], np.float64))
            roc._probs.append(np.asarray(d["probs"], np.float64))
        return roc

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_json(cls, s: str) -> "ROC":
        return cls.from_dict(json.loads(s))

    def merge(self, other: "ROC") -> "ROC":
        self._labels.extend(other._labels)
        self._probs.extend(other._probs)
        return self


class _ROCFamily:
    """Per-column serde/merge shared by ROCBinary and ROCMultiClass
    (both hold one exact-mode ROC per output column)."""

    _rocs: "Optional[List[ROC]]"

    def to_json(self) -> str:
        return json.dumps({
            "format_version": 1, "type": type(self).__name__,
            "columns": ([] if self._rocs is None
                        else [r.to_dict() for r in self._rocs]),
        })

    @classmethod
    def from_json(cls, s: str):
        d = json.loads(s)
        check_payload_type(d, cls.__name__)
        ev = cls()
        cols = d.get("columns")
        if cols is None:
            raise ValueError(f"{cls.__name__} payload has no 'columns'")
        if cols:
            ev._rocs = [ROC.from_dict(c) for c in cols]
        return ev

    def merge(self, other):
        if other._rocs is None:
            return self
        if self._rocs is None:
            # clone configuration, not just counts — a default ROC()
            # would silently drop the source's threshold_steps
            self._rocs = [ROC(threshold_steps=r.threshold_steps)
                          for r in other._rocs]
        if len(self._rocs) != len(other._rocs):
            raise ValueError("cannot merge ROC families with different "
                             "column counts")
        for a, b in zip(self._rocs, other._rocs):
            a.merge(b)
        return self


class ROCBinary(_ROCFamily):
    """Independent binary ROC per output column (reference
    `ROCBinary.java` for multi-label sigmoid outputs)."""

    def __init__(self, threshold_steps: int = 0):
        self.threshold_steps = threshold_steps
        self._rocs: Optional[List[ROC]] = None

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim == 3:
            c = labels.shape[-1]
            labels = labels.reshape(-1, c)
            predictions = predictions.reshape(-1, c)
        if self._rocs is None:
            self._rocs = [ROC(threshold_steps=self.threshold_steps)
                          for _ in range(labels.shape[-1])]
        for i, roc in enumerate(self._rocs):
            roc.eval(labels[:, i], predictions[:, i])

    def calculate_auc(self, col: int) -> float:
        return self._rocs[col].calculate_auc()

    def num_labels(self):
        return 0 if self._rocs is None else len(self._rocs)




class ROCMultiClass(_ROCFamily):
    """One-vs-all ROC per class (reference `ROCMultiClass.java`)."""

    def __init__(self, threshold_steps: int = 0):
        self.threshold_steps = threshold_steps
        self._rocs: Optional[List[ROC]] = None

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
        if self._rocs is None:
            self._rocs = [ROC(threshold_steps=self.threshold_steps)
                          for _ in range(labels.shape[-1])]
        for i, roc in enumerate(self._rocs):
            roc.eval(labels[:, i], predictions[:, i])

    def calculate_auc(self, cls: int) -> float:
        return self._rocs[cls].calculate_auc()

    def calculate_average_auc(self) -> float:
        return float(np.mean([r.calculate_auc() for r in self._rocs]))


