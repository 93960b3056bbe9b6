"""Termination conditions (counterpart of
`deeplearning4j_tpu/earlystopping/conditions.py`): the epoch and
iteration bases, MaxEpochs, ScoreImprovementEpoch, MaxScoreIteration,
MaxTimeIteration and InvalidScore (the NaN/Inf divergence guard)."""

from __future__ import annotations

import math
import time


class EpochTerminationCondition:
    def initialize(self):
        pass

    def terminate(self, epoch: int, score: float) -> bool:
        raise NotImplementedError


class IterationTerminationCondition:
    def initialize(self):
        pass

    def terminate(self, last_score: float) -> bool:
        raise NotImplementedError


class MaxEpochsTerminationCondition(EpochTerminationCondition):
    def __init__(self, max_epochs: int):
        self.max_epochs = max_epochs

    def terminate(self, epoch, score):
        return epoch + 1 >= self.max_epochs

    def __str__(self):
        return f"MaxEpochs({self.max_epochs})"


class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    """Stop after N epochs without score improvement (reference
    `ScoreImprovementEpochTerminationCondition.java`)."""

    def __init__(self, max_epochs_without_improvement: int, min_improvement: float = 0.0):
        self.patience = max_epochs_without_improvement
        self.min_improvement = min_improvement
        self.best = math.inf
        self.since = 0

    def initialize(self):
        self.best = math.inf
        self.since = 0

    def terminate(self, epoch, score):
        if score < self.best - self.min_improvement:
            self.best = score
            self.since = 0
            return False
        self.since += 1
        return self.since > self.patience

    def __str__(self):
        return f"ScoreImprovement(patience={self.patience})"


class MaxScoreIterationTerminationCondition(IterationTerminationCondition):
    def __init__(self, max_score: float):
        self.max_score = max_score

    def terminate(self, last_score):
        return last_score > self.max_score

    def __str__(self):
        return f"MaxScore({self.max_score})"


class MaxTimeIterationTerminationCondition(IterationTerminationCondition):
    def __init__(self, max_seconds: float):
        self.max_seconds = max_seconds
        self._start = None

    def initialize(self):
        self._start = time.monotonic()

    def terminate(self, last_score):
        if self._start is None:
            self._start = time.monotonic()
        return (time.monotonic() - self._start) > self.max_seconds

    def __str__(self):
        return f"MaxTime({self.max_seconds}s)"


class InvalidScoreIterationTerminationCondition(IterationTerminationCondition):
    """NaN/Inf divergence guard."""

    def terminate(self, last_score):
        return math.isnan(last_score) or math.isinf(last_score)

    def __str__(self):
        return "InvalidScore()"
