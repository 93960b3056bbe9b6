"""Evaluation (the port's own copies of the JAX package's numpy
evaluators): classification with a confusion matrix, ROC and
regression, fed by `MultiLayerNetwork.evaluate*`."""

from deeplearning4j_tpu_torch.eval.evaluation import (
    ConfusionMatrix,
    Evaluation,
)
from deeplearning4j_tpu_torch.eval.regression import RegressionEvaluation
from deeplearning4j_tpu_torch.eval.roc import ROC, ROCBinary, ROCMultiClass

__all__ = ["ConfusionMatrix", "Evaluation", "ROC", "ROCBinary",
           "ROCMultiClass", "RegressionEvaluation"]
