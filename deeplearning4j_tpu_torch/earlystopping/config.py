"""EarlyStoppingConfiguration and EarlyStoppingResult (counterpart of
`deeplearning4j_tpu/earlystopping/config.py`)."""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Any, List, Optional


class TerminationReason(str, Enum):
    EPOCH_TERMINATION = "epoch_termination"
    ITERATION_TERMINATION = "iteration_termination"
    MAX_EPOCHS = "max_epochs"
    ERROR = "error"


@dataclasses.dataclass
class EarlyStoppingConfiguration:
    score_calculator: Any = None
    model_saver: Any = None
    epoch_termination_conditions: List = dataclasses.field(default_factory=list)
    iteration_termination_conditions: List = dataclasses.field(default_factory=list)
    evaluate_every_n_epochs: int = 1
    save_last_model: bool = False


@dataclasses.dataclass
class EarlyStoppingResult:
    termination_reason: TerminationReason
    termination_details: str
    score_vs_epoch: dict
    best_model_epoch: int
    best_model_score: float
    total_epochs: int
    best_model: Any = None
