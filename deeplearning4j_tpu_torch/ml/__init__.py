"""ML-pipeline adapters (counterpart of `deeplearning4j_tpu/ml/`, the
dl4j-spark-ml role): sklearn-style Estimator/Transformer wrappers around
the port's networks, so they slot into sklearn Pipelines and
model-selection tooling."""

from deeplearning4j_tpu_torch.ml.estimator import (
    AutoEncoderEstimator,
    NetworkEstimator,
)
