"""Evaluation (the port's own copies of the JAX package's numpy
evaluators): classification with a confusion matrix, ROC, regression,
per-output binary and calibration, fed by `MultiLayerNetwork.evaluate*`;
`EvaluationTools` renders ROC and calibration charts as HTML."""

from deeplearning4j_tpu_torch.eval.binary import EvaluationBinary
from deeplearning4j_tpu_torch.eval.calibration import EvaluationCalibration
from deeplearning4j_tpu_torch.eval.evaluation import (
    ConfusionMatrix,
    Evaluation,
)
from deeplearning4j_tpu_torch.eval.regression import RegressionEvaluation
from deeplearning4j_tpu_torch.eval.roc import ROC, ROCBinary, ROCMultiClass
from deeplearning4j_tpu_torch.eval.tools import EvaluationTools

__all__ = ["ConfusionMatrix", "Evaluation", "EvaluationBinary",
           "EvaluationCalibration", "EvaluationTools", "ROC", "ROCBinary",
           "ROCMultiClass", "RegressionEvaluation"]
