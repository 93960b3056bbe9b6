"""The port's per-output binary and calibration evaluators and its HTML
rendering (`deeplearning4j_tpu_torch/eval/{binary,calibration,tools}.py`)
against the JAX package's on the same seeded predictions: the same
counts, metrics, JSON and HTML."""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import json

import numpy as np
import pytest

from deeplearning4j_tpu.eval.binary import EvaluationBinary as JaxBinary
from deeplearning4j_tpu.eval.calibration import (
    EvaluationCalibration as JaxCalibration,
)
from deeplearning4j_tpu.eval.roc import ROC as JaxROC
from deeplearning4j_tpu.eval.tools import EvaluationTools as JaxTools
from deeplearning4j_tpu_torch.eval import (
    ROC,
    EvaluationBinary,
    EvaluationCalibration,
    EvaluationTools,
)


def _batches(shape3=False, seed=0):
    """(labels, predictions, mask) batches: 2-d [N, C], or 3-d [B, T, C]
    with a [B, T] mask."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        if shape3:
            y = (rng.random((4, 6, 3)) < 0.4).astype(np.float32)
            p = rng.random((4, 6, 3)).astype(np.float32)
            m = (rng.random((4, 6)) < 0.8).astype(np.float32)
        else:
            y = (rng.random((20, 3)) < 0.4).astype(np.float32)
            p = rng.random((20, 3)).astype(np.float32)
            m = None
        out.append((y, p, m))
    return out


@pytest.mark.parametrize("shape3", [False, True], ids=["2d", "3d_masked"])
def test_binary_matches_jax(shape3):
    port, jax_ = EvaluationBinary(threshold=0.45), JaxBinary(threshold=0.45)
    for y, p, m in _batches(shape3):
        port.eval(y, p, mask=m)
        jax_.eval(y, p, mask=m)
    assert port.num_labels() == jax_.num_labels() == 3
    for c in range(3):
        for f in ("accuracy", "precision", "recall", "f1", "true_positives",
                  "false_positives", "true_negatives", "false_negatives"):
            assert getattr(port, f)(c) == getattr(jax_, f)(c), (f, c)
    assert port.to_json() == jax_.to_json()
    assert port.stats() == jax_.stats()
    back = EvaluationBinary.from_json(jax_.to_json())
    assert back.to_json() == port.to_json()
    merged = EvaluationBinary(0.45).merge(port).merge(back)
    jmerged = JaxBinary(0.45).merge(jax_).merge(JaxBinary.from_json(
        jax_.to_json()))
    assert merged.to_json() == jmerged.to_json()
    with pytest.raises(ValueError):
        EvaluationBinary(0.5).merge(port)


@pytest.mark.parametrize("case", ["2d", "2d_masked", "3d_masked"])
def test_calibration_matches_jax(case):
    port = EvaluationCalibration(reliability_bins=8, histogram_bins=6)
    jax_ = JaxCalibration(reliability_bins=8, histogram_bins=6)
    rng = np.random.default_rng(3)
    for y, p, m in _batches(case == "3d_masked", seed=1):
        if case == "2d_masked":
            m = (rng.random(y.shape[0]) < 0.7).astype(np.float32)
        port.eval(y, p, mask=m)
        jax_.eval(y, p, mask=m)
    assert port.to_json() == jax_.to_json()
    for c in range(3):
        for a, b in zip(port.reliability_diagram(c),
                        jax_.reliability_diagram(c)):
            np.testing.assert_array_equal(a, b)
        assert (port.expected_calibration_error(c)
                == jax_.expected_calibration_error(c))
        np.testing.assert_array_equal(port.probability_histogram(c),
                                      jax_.probability_histogram(c))
        assert (port.get_residual_plot(c).to_json()
                == jax_.get_residual_plot(c).to_json())
        assert (port.get_reliability_diagram(c).to_json()
                == jax_.get_reliability_diagram(c).to_json())
    merged = EvaluationCalibration(8, 6).merge(port).merge(
        EvaluationCalibration.from_json(port.to_json()))
    jmerged = JaxCalibration(8, 6).merge(jax_).merge(
        JaxCalibration.from_json(jax_.to_json()))
    assert merged.to_json() == jmerged.to_json()


def test_fresh_calibration_serializes():
    """An evaluator that has seen nothing writes its JSON (the JAX copy
    raises AttributeError there: `_residual_hist` is only made by its
    first `eval`)."""
    d = json.loads(EvaluationCalibration().to_json())
    assert d["_residual_hist"] is None and d["_bin_counts"] is None
    with pytest.raises(AttributeError):
        JaxCalibration().to_json()


def test_tools_html_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 64)]
    p = rng.random(64).astype(np.float32)
    p = np.stack([1 - p, p], axis=1)
    roc, jroc = ROC(), JaxROC()
    roc.eval(y, p)
    jroc.eval(y, p)
    assert (EvaluationTools.roc_chart_html(roc)
            == JaxTools.roc_chart_html(jroc))
    cal, jcal = EvaluationCalibration(), JaxCalibration()
    cal.eval(y, p)
    jcal.eval(y, p)
    html = EvaluationTools.calibration_chart_html(cal, 2)
    assert html == JaxTools.calibration_chart_html(jcal, 2)
    EvaluationTools.export_calibration_to_html_file(cal, 2,
                                                    tmp_path / "c.html")
    EvaluationTools.export_roc_charts_to_html_file(roc, tmp_path / "r.html")
    assert (tmp_path / "c.html").read_text() == html
    assert "<svg" in (tmp_path / "r.html").read_text()
