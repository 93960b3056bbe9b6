"""The port's own copy of `deeplearning4j_tpu/eval/regression.py` (numpy only;
the port imports nothing of the JAX package).

Regression evaluation.

Reference: `eval/RegressionEvaluation.java`: per-column MSE, MAE, RMSE,
RSE (relative squared error), R² (correlation-based in the reference),
with mask support for time series.
"""

from __future__ import annotations

from typing import Optional

import json

import numpy as np

from deeplearning4j_tpu_torch.eval.evaluation import check_payload_type


class RegressionEvaluation:
    def __init__(self, num_columns: Optional[int] = None, column_names=None):
        self.num_columns = num_columns
        self.column_names = column_names
        self._sum_err2 = None
        self._sum_abs = None
        self._sum_label = None
        self._sum_label2 = None
        self._sum_pred = None
        self._sum_pred2 = None
        self._sum_label_pred = None
        self._count = None

    def _ensure(self, c):
        if self._sum_err2 is None:
            self.num_columns = self.num_columns or c
            z = lambda: np.zeros(self.num_columns, dtype=np.float64)
            self._sum_err2, self._sum_abs = z(), z()
            self._sum_label, self._sum_label2 = z(), z()
            self._sum_pred, self._sum_pred2 = z(), z()
            self._sum_label_pred, self._count = z(), z()

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels, dtype=np.float64)
        predictions = np.asarray(predictions, dtype=np.float64)
        if labels.ndim == 3:
            b, t, c = labels.shape
            labels = labels.reshape(-1, c)
            predictions = predictions.reshape(-1, c)
            if mask is not None:
                m = np.asarray(mask).reshape(-1).astype(bool)
                labels, predictions = labels[m], predictions[m]
        self._ensure(labels.shape[-1])
        err = predictions - labels
        self._sum_err2 += np.sum(err ** 2, axis=0)
        self._sum_abs += np.sum(np.abs(err), axis=0)
        self._sum_label += np.sum(labels, axis=0)
        self._sum_label2 += np.sum(labels ** 2, axis=0)
        self._sum_pred += np.sum(predictions, axis=0)
        self._sum_pred2 += np.sum(predictions ** 2, axis=0)
        self._sum_label_pred += np.sum(labels * predictions, axis=0)
        self._count += labels.shape[0]

    def mean_squared_error(self, col: int) -> float:
        return float(self._sum_err2[col] / self._count[col])

    def mean_absolute_error(self, col: int) -> float:
        return float(self._sum_abs[col] / self._count[col])

    def root_mean_squared_error(self, col: int) -> float:
        return float(np.sqrt(self.mean_squared_error(col)))

    def relative_squared_error(self, col: int) -> float:
        n = self._count[col]
        mean_label = self._sum_label[col] / n
        ss_tot = self._sum_label2[col] - n * mean_label ** 2
        return float(self._sum_err2[col] / ss_tot) if ss_tot else float("inf")

    def correlation_r2(self, col: int) -> float:
        n = self._count[col]
        cov = self._sum_label_pred[col] - self._sum_label[col] * self._sum_pred[col] / n
        var_l = self._sum_label2[col] - self._sum_label[col] ** 2 / n
        var_p = self._sum_pred2[col] - self._sum_pred[col] ** 2 / n
        denom = np.sqrt(var_l * var_p)
        return float((cov / denom) ** 2) if denom else 0.0

    def average_mean_squared_error(self) -> float:
        return float(np.mean(self._sum_err2 / self._count))

    def average_mean_absolute_error(self) -> float:
        return float(np.mean(self._sum_abs / self._count))

    def average_root_mean_squared_error(self) -> float:
        return float(np.mean(np.sqrt(self._sum_err2 / self._count)))


    # ---- serde (reference BaseEvaluation.toJson/fromJson) ----------------
    _SUM_FIELDS = ("_sum_err2", "_sum_abs", "_sum_label", "_sum_label2",
                   "_sum_pred", "_sum_pred2", "_sum_label_pred", "_count")

    def to_json(self) -> str:
        d = {"format_version": 1, "type": "RegressionEvaluation",
             "num_columns": self.num_columns,
             "column_names": self.column_names}
        for f in self._SUM_FIELDS:
            v = getattr(self, f)
            d[f] = None if v is None else v.tolist()
        return json.dumps(d)

    @classmethod
    def from_json(cls, s: str) -> "RegressionEvaluation":
        d = json.loads(s)
        check_payload_type(d, "RegressionEvaluation")
        ev = cls(num_columns=d["num_columns"], column_names=d.get("column_names"))
        for f in cls._SUM_FIELDS:
            if d.get(f) is not None:
                setattr(ev, f, np.asarray(d[f], np.float64))
        return ev

    def merge(self, other: "RegressionEvaluation") -> "RegressionEvaluation":
        """Accumulator merge (the Spark tree-aggregate role)."""
        if other._sum_err2 is None:
            return self
        self._ensure(other.num_columns)
        for f in self._SUM_FIELDS:
            setattr(self, f, getattr(self, f) + getattr(other, f))
        return self

    def stats(self) -> str:
        lines = ["Column    MSE            MAE            RMSE           RSE            R^2"]
        for c in range(self.num_columns):
            name = self.column_names[c] if self.column_names else f"col_{c}"
            lines.append(f"{name:<9} {self.mean_squared_error(c):<14.6g} "
                         f"{self.mean_absolute_error(c):<14.6g} "
                         f"{self.root_mean_squared_error(c):<14.6g} "
                         f"{self.relative_squared_error(c):<14.6g} "
                         f"{self.correlation_r2(c):<14.6g}")
        return "\n".join(lines)
