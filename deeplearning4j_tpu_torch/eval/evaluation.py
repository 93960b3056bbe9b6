"""The port's own copy of `deeplearning4j_tpu/eval/evaluation.py` (numpy only;
the port imports nothing of the JAX package).

Classification evaluation with confusion matrix.

Reference: `eval/Evaluation.java` (1,627 LoC): `eval()` accumulates a
confusion matrix from (labels, predictions); metrics: accuracy :1138,
precision :664, recall :803, f1 :1031, fBeta :998, gMeasure :1094,
falsePositiveRate :851, falseNegativeRate :913, falseAlarmRate :975,
matthewsCorrelation :1170, MACRO/MICRO averaging overloads
(EvaluationAveraging), per-class count maps :1218-1262, label-name-aware
stats() report :499-509 with warning surfacing, JSON serde
(`BaseEvaluation.toJson`), merge :1392. Time-series inputs are flattened
with mask support (`evalTimeSeries`). Binary decision threshold and
cost-array constructors :156-180.
"""

from __future__ import annotations

import json
from enum import Enum
from typing import Dict, List, Optional

import numpy as np


def check_payload_type(d: dict, expected: str):
    """Shared serde guard: every evaluator's JSON payload carries a
    type tag; reject mismatches with one consistent error."""
    if d.get("type") != expected:
        raise ValueError(f"Not a(n) {expected} payload: {d.get('type')!r}")


class EvaluationAveraging(str, Enum):
    MACRO = "macro"
    MICRO = "micro"


class ConfusionMatrix:
    def __init__(self, num_classes: int):
        self.matrix = np.zeros((num_classes, num_classes), dtype=np.int64)

    def add(self, actual: np.ndarray, predicted: np.ndarray):
        np.add.at(self.matrix, (actual, predicted), 1)

    def get_count(self, actual: int, predicted: int) -> int:
        return int(self.matrix[actual, predicted])

    def __str__(self):
        return str(self.matrix)


def _flatten_time_series(labels, preds, mask):
    """[B,T,C] → [B*T, C], dropping masked steps (reference
    evalTimeSeries + MaskedReductionUtil)."""
    labels = np.asarray(labels)
    preds = np.asarray(preds)
    if labels.ndim == 3:
        b, t, c = labels.shape
        labels = labels.reshape(b * t, c)
        preds = preds.reshape(b * t, c)
        if mask is not None:
            m = np.asarray(mask).reshape(-1).astype(bool)
            labels, preds = labels[m], preds[m]
    return labels, preds


class Evaluation:
    def __init__(self, num_classes: Optional[int] = None, top_n: int = 1,
                 labels_names: Optional[List[str]] = None,
                 binary_decision_threshold: Optional[float] = None,
                 cost_array: Optional[np.ndarray] = None):
        if isinstance(num_classes, (list, tuple)):  # Evaluation(labels) ctor
            labels_names, num_classes = list(num_classes), len(num_classes)
        self.num_classes = num_classes
        self.top_n = top_n
        self.labels_names = labels_names
        # reference ctors :156-180 — threshold for binary problems,
        # per-class cost multipliers applied before argmax
        self.binary_decision_threshold = binary_decision_threshold
        self.cost_array = (None if cost_array is None
                           else np.asarray(cost_array, np.float64))
        self.confusion: Optional[ConfusionMatrix] = None
        self.top_n_correct = 0
        self.total = 0
        # per-example Prediction tracking, populated only when eval() is
        # given record metadata (reference eval/meta/Prediction.java)
        from deeplearning4j_tpu_torch.eval.meta import PredictionLedger
        self._ledger = PredictionLedger()

    def _ensure(self, c):
        if self.confusion is None:
            self.num_classes = self.num_classes or c
            self.confusion = ConfusionMatrix(self.num_classes)

    def reset(self):
        self.confusion = None
        self.top_n_correct = 0
        self.total = 0
        from deeplearning4j_tpu_torch.eval.meta import PredictionLedger
        self._ledger = PredictionLedger()

    def eval(self, labels, predictions, mask=None, record_metadata=None):
        labels, predictions = _flatten_time_series(labels, predictions, mask)
        self._ensure(labels.shape[-1])
        actual = np.argmax(labels, axis=-1)
        if (self.binary_decision_threshold is not None
                and predictions.shape[-1] == 2):
            pred = (predictions[:, 1] >=
                    self.binary_decision_threshold).astype(np.int64)
        elif self.cost_array is not None:
            pred = np.argmax(predictions * self.cost_array[None, :], axis=-1)
        else:
            pred = np.argmax(predictions, axis=-1)
        if record_metadata is not None:
            # time-series flattening / masking can change the row count;
            # silently misaligned attribution would be worse than failing
            if len(record_metadata) != len(actual):
                raise ValueError(
                    f"record_metadata has {len(record_metadata)} entries but "
                    f"evaluation flattened/masked to {len(actual)} rows; "
                    "per-example metadata tracking supports 2-d labels (or "
                    "pre-flattened metadata aligned with kept rows)")
            self._ledger.record(actual, pred, record_metadata)
        self.confusion.add(actual, pred)
        self.total += len(actual)
        if self.top_n > 1:
            order = np.argsort(predictions, axis=-1)[:, ::-1][:, :self.top_n]
            self.top_n_correct += int(np.sum(order == actual[:, None]))
        else:
            self.top_n_correct += int(np.sum(actual == pred))

    def eval_single(self, actual: int, predicted: int):
        """One (actual, predicted) pair (reference `eval(int,int)` :461)."""
        if self.confusion is None:
            if self.num_classes is None:
                raise ValueError("num_classes required for eval_single")
            self._ensure(self.num_classes)
        self.confusion.matrix[actual, predicted] += 1
        self.total += 1
        if actual == predicted:
            self.top_n_correct += 1

    # ---- counts ----------------------------------------------------------
    def true_positives(self) -> Dict[int, int]:
        return {i: int(self.confusion.matrix[i, i]) for i in range(self.num_classes)}

    def false_positives(self) -> Dict[int, int]:
        return {i: int(self.confusion.matrix[:, i].sum() - self.confusion.matrix[i, i])
                for i in range(self.num_classes)}

    def false_negatives(self) -> Dict[int, int]:
        return {i: int(self.confusion.matrix[i, :].sum() - self.confusion.matrix[i, i])
                for i in range(self.num_classes)}

    def true_negatives(self) -> Dict[int, int]:
        total = self.confusion.matrix.sum()
        return {i: int(total - self.confusion.matrix[i, :].sum()
                       - self.confusion.matrix[:, i].sum() + self.confusion.matrix[i, i])
                for i in range(self.num_classes)}

    def positive(self) -> Dict[int, int]:
        """Actual occurrences per class (reference :1262)."""
        return {i: int(self.confusion.matrix[i, :].sum())
                for i in range(self.num_classes)}

    def negative(self) -> Dict[int, int]:
        """Actual non-occurrences per class (reference :1254)."""
        total = self.confusion.matrix.sum()
        return {i: int(total - self.confusion.matrix[i, :].sum())
                for i in range(self.num_classes)}

    def class_count(self, cls: int) -> int:
        """#examples whose actual class is `cls` (reference :1332)."""
        return int(self.confusion.matrix[cls, :].sum())

    def get_num_row_counter(self) -> int:
        return self.total

    def get_class_label(self, cls: int) -> str:
        if self.labels_names and cls < len(self.labels_names):
            return self.labels_names[cls]
        return str(cls)

    # ---- per-example metadata (reference Evaluation.java meta overloads)
    def get_prediction_errors(self):
        return self._ledger.get_prediction_errors()

    def get_predictions_by_actual_class(self, cls: int):
        return self._ledger.get_predictions_by_actual_class(cls)

    def get_predictions_by_predicted_class(self, cls: int):
        return self._ledger.get_predictions_by_predicted_class(cls)

    def get_predictions(self, actual: int, predicted: int):
        return self._ledger.get_predictions(actual, predicted)

    # ---- metrics ---------------------------------------------------------
    def accuracy(self) -> float:
        if self.total == 0:
            return 0.0
        return float(np.trace(self.confusion.matrix)) / self.total

    def top_n_accuracy(self) -> float:
        return self.top_n_correct / self.total if self.total else 0.0

    def _averaged(self, per_class_fn, averaging, micro_num_fn, micro_den_fn):
        if averaging in (None, EvaluationAveraging.MACRO, "macro"):
            vals = [per_class_fn(i) for i in range(self.num_classes)]
            return float(np.mean(vals)) if vals else 0.0
        num = sum(micro_num_fn(i) for i in range(self.num_classes))
        den = sum(micro_den_fn(i) for i in range(self.num_classes))
        return float(num / den) if den else 0.0

    def precision(self, cls: Optional[int] = None, averaging=None) -> float:
        if cls is not None:
            denom = self.confusion.matrix[:, cls].sum()
            return float(self.confusion.matrix[cls, cls] / denom) if denom else 0.0
        if averaging is not None:
            tp, fp = self.true_positives(), self.false_positives()
            return self._averaged(self.precision, averaging,
                                  lambda i: tp[i], lambda i: tp[i] + fp[i])
        vals = [self.precision(i) for i in range(self.num_classes)
                if self.confusion.matrix[:, i].sum() > 0 or self.confusion.matrix[i, :].sum() > 0]
        return float(np.mean(vals)) if vals else 0.0

    def recall(self, cls: Optional[int] = None, averaging=None) -> float:
        if cls is not None:
            denom = self.confusion.matrix[cls, :].sum()
            return float(self.confusion.matrix[cls, cls] / denom) if denom else 0.0
        if averaging is not None:
            tp, fn = self.true_positives(), self.false_negatives()
            return self._averaged(self.recall, averaging,
                                  lambda i: tp[i], lambda i: tp[i] + fn[i])
        vals = [self.recall(i) for i in range(self.num_classes)
                if self.confusion.matrix[i, :].sum() > 0]
        return float(np.mean(vals)) if vals else 0.0

    def false_positive_rate(self, cls: Optional[int] = None,
                            averaging=None) -> float:
        """FP / (FP + TN) (reference :851-885)."""
        if cls is not None:
            fp = self.false_positives()[cls]
            tn = self.true_negatives()[cls]
            return float(fp / (fp + tn)) if (fp + tn) else 0.0
        fp, tn = self.false_positives(), self.true_negatives()
        return self._averaged(self.false_positive_rate, averaging,
                              lambda i: fp[i], lambda i: fp[i] + tn[i])

    def false_negative_rate(self, cls: Optional[int] = None,
                            averaging=None) -> float:
        """FN / (FN + TP) (reference :913-947)."""
        if cls is not None:
            fn = self.false_negatives()[cls]
            tp = self.true_positives()[cls]
            return float(fn / (fn + tp)) if (fn + tp) else 0.0
        fn, tp = self.false_negatives(), self.true_positives()
        return self._averaged(self.false_negative_rate, averaging,
                              lambda i: fn[i], lambda i: fn[i] + tp[i])

    def false_alarm_rate(self) -> float:
        """(FPR + FNR) / 2 (reference :975)."""
        return (self.false_positive_rate() + self.false_negative_rate()) / 2.0

    def f_beta(self, beta: float, cls: Optional[int] = None,
               averaging=None) -> float:
        """F_beta = (1+β²)·P·R / (β²·P + R) (reference :998-1050)."""
        if cls is not None:
            p, r = self.precision(cls), self.recall(cls)
            d = beta * beta * p + r
            return float((1 + beta * beta) * p * r / d) if d else 0.0
        if averaging in (EvaluationAveraging.MICRO, "micro"):
            p = self.precision(averaging=EvaluationAveraging.MICRO)
            r = self.recall(averaging=EvaluationAveraging.MICRO)
            d = beta * beta * p + r
            return float((1 + beta * beta) * p * r / d) if d else 0.0
        vals = [self.f_beta(beta, i) for i in range(self.num_classes)]
        return float(np.mean(vals)) if vals else 0.0

    def f1(self, cls: Optional[int] = None, averaging=None) -> float:
        if cls is not None:
            return self.f_beta(1.0, cls)
        if averaging is not None:
            return self.f_beta(1.0, averaging=averaging)
        vals = [self.f1(i) for i in range(self.num_classes)
                if self.confusion.matrix[i, :].sum() > 0]
        return float(np.mean(vals)) if vals else 0.0

    def gmeasure(self, cls: Optional[int] = None, averaging=None) -> float:
        if cls is not None:
            return float(np.sqrt(self.precision(cls) * self.recall(cls)))
        if averaging in (EvaluationAveraging.MICRO, "micro"):
            p = self.precision(averaging=EvaluationAveraging.MICRO)
            r = self.recall(averaging=EvaluationAveraging.MICRO)
            return float(np.sqrt(p * r))
        vals = [self.gmeasure(i) for i in range(self.num_classes)]
        return float(np.mean(vals)) if vals else 0.0

    def matthews_correlation(self, cls: Optional[int] = None,
                             averaging=None) -> float:
        if cls is None:
            if averaging in (EvaluationAveraging.MICRO, "micro"):
                # reference :1184 MICRO: one MCC from the summed counts
                tp = sum(self.true_positives().values())
                fp = sum(self.false_positives().values())
                fn = sum(self.false_negatives().values())
                tn = sum(self.true_negatives().values())
                denom = np.sqrt(float(tp + fp) * (tp + fn)
                                * (tn + fp) * (tn + fn))
                return float((tp * tn - fp * fn) / denom) if denom else 0.0
            vals = [self.matthews_correlation(i)
                    for i in range(self.num_classes)]
            return float(np.mean(vals)) if vals else 0.0
        tp = self.true_positives()[cls]
        fp = self.false_positives()[cls]
        fn = self.false_negatives()[cls]
        tn = self.true_negatives()[cls]
        denom = np.sqrt(float(tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
        return float((tp * tn - fp * fn) / denom) if denom else 0.0

    # ---- reporting -------------------------------------------------------
    def warnings(self) -> List[str]:
        """Degenerate-class warnings the reference surfaces in stats()
        (classes never predicted / absent from the data)."""
        out = []
        if self.confusion is None:
            return ["evaluation saw no data"]
        for i in range(self.num_classes):
            name = self.get_class_label(i)
            if self.confusion.matrix[i, :].sum() == 0:
                out.append(f"class {name} never appeared as an actual label")
            elif self.confusion.matrix[:, i].sum() == 0:
                out.append(f"class {name} was never predicted by the model")
        return out

    def stats(self, suppress_warnings: bool = False,
              include_per_class: bool = True) -> str:
        """Label-name-aware report (reference stats() :499-509)."""
        lines = ["========================Evaluation Metrics========================",
                 f" # of classes:    {self.num_classes}",
                 f" Accuracy:        {self.accuracy():.4f}",
                 f" Precision:       {self.precision():.4f}",
                 f" Recall:          {self.recall():.4f}",
                 f" F1 Score:        {self.f1():.4f}"]
        if self.top_n > 1:
            lines.append(f" Top-{self.top_n} Accuracy: {self.top_n_accuracy():.4f}")
        if include_per_class and self.num_classes:
            w = max([5] + [len(self.get_class_label(i))
                           for i in range(self.num_classes)])
            lines.append("")
            lines.append(f" {'Label':<{w}}  Precision  Recall   F1       "
                         f"FPR      FNR      Count")
            for i in range(self.num_classes):
                lines.append(
                    f" {self.get_class_label(i):<{w}}  "
                    f"{self.precision(i):<9.4f}  {self.recall(i):<7.4f}  "
                    f"{self.f1(i):<7.4f}  {self.false_positive_rate(i):<7.4f}  "
                    f"{self.false_negative_rate(i):<7.4f}  {self.class_count(i)}")
        if not suppress_warnings:
            warns = self.warnings()
            if warns:
                lines.append("")
                lines.extend(f" Warning: {wmsg}" for wmsg in warns)
        lines.append("\n=========================Confusion Matrix=========================")
        if self.labels_names:
            lines.append(" labels: " + ", ".join(
                f"{i}={self.get_class_label(i)}"
                for i in range(self.num_classes)))
        lines.append(str(self.confusion))
        return "\n".join(lines)

    # ---- serde (reference BaseEvaluation.toJson/fromJson) ---------------
    def to_json(self) -> str:
        return json.dumps({
            "format_version": 1,
            "type": "Evaluation",
            "num_classes": self.num_classes,
            "top_n": self.top_n,
            "top_n_correct": self.top_n_correct,
            "total": self.total,
            "labels_names": self.labels_names,
            "binary_decision_threshold": self.binary_decision_threshold,
            "cost_array": (None if self.cost_array is None
                           else self.cost_array.tolist()),
            "confusion": (None if self.confusion is None
                          else self.confusion.matrix.tolist()),
        })

    @classmethod
    def from_json(cls, s: str) -> "Evaluation":
        d = json.loads(s)
        check_payload_type(d, "Evaluation")
        ev = cls(num_classes=d["num_classes"], top_n=d["top_n"],
                 labels_names=d.get("labels_names"),
                 binary_decision_threshold=d.get("binary_decision_threshold"),
                 cost_array=d.get("cost_array"))
        ev.top_n_correct = d["top_n_correct"]
        ev.total = d["total"]
        if d.get("confusion") is not None:
            ev._ensure(d["num_classes"])
            ev.confusion.matrix = np.asarray(d["confusion"], np.int64)
        return ev

    def merge(self, other: "Evaluation"):
        if other.confusion is None:
            return self
        self._ensure(other.num_classes)
        self.confusion.matrix += other.confusion.matrix
        self.total += other.total
        self.top_n_correct += other.top_n_correct
        return self
