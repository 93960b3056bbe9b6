"""Transfer learning (counterpart of `deeplearning4j_tpu/transferlearning/`)."""

from deeplearning4j_tpu_torch.transferlearning.transfer import (
    FineTuneConfiguration,
    TransferLearning,
    TransferLearningHelper,
)
