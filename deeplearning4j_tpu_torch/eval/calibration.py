"""The port's own copy of `deeplearning4j_tpu/eval/calibration.py` (numpy only;
the port imports nothing of the JAX package).

Calibration evaluation: reliability diagram + histograms.

Reference: `eval/EvaluationCalibration.java`: bins predicted
probabilities, tracks observed positive fraction per bin (reliability
diagram data), residual plot + probability histogram.
"""

from __future__ import annotations

import json

import numpy as np

from deeplearning4j_tpu_torch.eval.evaluation import check_payload_type


class EvaluationCalibration:
    def __init__(self, reliability_bins: int = 10, histogram_bins: int = 10):
        self.reliability_bins = reliability_bins
        self.histogram_bins = histogram_bins
        self._bin_counts = None
        self._bin_pos = None
        self._bin_prob_sum = None
        self._prob_hist = None
        self._residual_hist = None

    def _ensure(self, c):
        if self._bin_counts is None:
            self._bin_counts = np.zeros((c, self.reliability_bins), dtype=np.int64)
            self._bin_pos = np.zeros((c, self.reliability_bins), dtype=np.int64)
            self._bin_prob_sum = np.zeros((c, self.reliability_bins), dtype=np.float64)
            self._prob_hist = np.zeros((c, self.histogram_bins), dtype=np.int64)
            self._residual_hist = np.zeros((c, self.histogram_bins),
                                           dtype=np.int64)

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
        elif mask is not None:
            # 2-d path: [N] example mask — masked rows must not be binned
            m = np.asarray(mask).reshape(-1).astype(bool)
            labels, predictions = labels[m], predictions[m]
        self._ensure(labels.shape[-1])
        bins = np.clip((predictions * self.reliability_bins).astype(int), 0,
                       self.reliability_bins - 1)
        hbins = np.clip((predictions * self.histogram_bins).astype(int), 0,
                        self.histogram_bins - 1)
        residuals = np.abs(labels - predictions)
        rbins = np.clip((residuals * self.histogram_bins).astype(int), 0,
                        self.histogram_bins - 1)
        for c in range(labels.shape[-1]):
            np.add.at(self._bin_counts[c], bins[:, c], 1)
            np.add.at(self._bin_pos[c], bins[:, c], labels[:, c] >= 0.5)
            np.add.at(self._bin_prob_sum[c], bins[:, c], predictions[:, c])
            np.add.at(self._prob_hist[c], hbins[:, c], 1)
            np.add.at(self._residual_hist[c], rbins[:, c], 1)

    def reliability_diagram(self, cls: int):
        """Returns (mean_predicted_prob, observed_fraction) per bin."""
        counts = np.maximum(self._bin_counts[cls], 1)
        return (self._bin_prob_sum[cls] / counts, self._bin_pos[cls] / counts)

    def expected_calibration_error(self, cls: int) -> float:
        counts = self._bin_counts[cls]
        total = counts.sum()
        if not total:
            return 0.0
        mean_p, obs = self.reliability_diagram(cls)
        return float(np.sum(counts / total * np.abs(mean_p - obs)))

    def probability_histogram(self, cls: int):
        return self._prob_hist[cls].copy()

    # ---- serializable curve objects (reference getReliabilityDiagram /
    # getProbabilityHistogram return eval/curves types)
    def get_reliability_diagram(self, cls: int):
        from deeplearning4j_tpu_torch.eval.curves import ReliabilityDiagram
        mean_p, obs = self.reliability_diagram(cls)
        return ReliabilityDiagram(f"class {cls}", mean_p, obs)

    def get_probability_histogram(self, cls: int):
        from deeplearning4j_tpu_torch.eval.curves import Histogram
        return Histogram(f"P(class {cls})", 0.0, 1.0,
                         self._prob_hist[cls].copy())

    def get_residual_plot(self, cls: int):
        """|label − p| histogram (reference `getResidualPlot`)."""
        from deeplearning4j_tpu_torch.eval.curves import Histogram
        return Histogram(f"|label - P| (class {cls})", 0.0, 1.0,
                         self._residual_hist[cls].copy())

    # ---- serde + merge ---------------------------------------------------
    _ACC_FIELDS = ("_bin_counts", "_bin_pos", "_bin_prob_sum", "_prob_hist",
                   "_residual_hist")

    def to_json(self) -> str:
        d = {"format_version": 1, "type": "EvaluationCalibration",
             "reliability_bins": self.reliability_bins,
             "histogram_bins": self.histogram_bins}
        for f in self._ACC_FIELDS:
            v = getattr(self, f)
            d[f] = None if v is None else v.tolist()
        return json.dumps(d)

    @classmethod
    def from_json(cls, s: str) -> "EvaluationCalibration":
        d = json.loads(s)
        check_payload_type(d, "EvaluationCalibration")
        ev = cls(reliability_bins=d["reliability_bins"],
                 histogram_bins=d["histogram_bins"])
        for f in cls._ACC_FIELDS:
            if d.get(f) is not None:
                arr = np.asarray(d[f])
                setattr(ev, f, arr.astype(
                    np.int64 if f != "_bin_prob_sum" else np.float64))
        return ev

    def merge(self, other: "EvaluationCalibration") -> "EvaluationCalibration":
        if other._bin_counts is None:
            return self
        if (other.reliability_bins != self.reliability_bins
                or other.histogram_bins != self.histogram_bins):
            raise ValueError("cannot merge calibrations with different bins")
        self._ensure(other._bin_counts.shape[0])
        for f in self._ACC_FIELDS:
            setattr(self, f, getattr(self, f) + getattr(other, f))
        return self
