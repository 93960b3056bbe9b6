"""Early stopping (counterpart of `deeplearning4j_tpu/earlystopping/`):
configuration, termination conditions, score calculators, model savers
and the trainers: `EarlyStoppingTrainer` (and its graph alias) and
`EarlyStoppingParallelTrainer`, whose epochs run through a
`ParallelTrainer` on a mesh."""

from deeplearning4j_tpu_torch.earlystopping.conditions import (
    EpochTerminationCondition,
    InvalidScoreIterationTerminationCondition,
    IterationTerminationCondition,
    MaxEpochsTerminationCondition,
    MaxScoreIterationTerminationCondition,
    MaxTimeIterationTerminationCondition,
    ScoreImprovementEpochTerminationCondition,
)
from deeplearning4j_tpu_torch.earlystopping.config import (
    EarlyStoppingConfiguration,
    EarlyStoppingResult,
    TerminationReason,
)
from deeplearning4j_tpu_torch.earlystopping.savers import (
    InMemoryModelSaver,
    LocalFileModelSaver,
)
from deeplearning4j_tpu_torch.earlystopping.scorecalc import (
    ClassificationScoreCalculator,
    DataSetLossCalculator,
)
from deeplearning4j_tpu_torch.earlystopping.trainer import (
    EarlyStoppingGraphTrainer,
    EarlyStoppingParallelTrainer,
    EarlyStoppingTrainer,
)
