"""Training listeners (counterpart of
`deeplearning4j_tpu/optimize/listeners.py` :19-200): the callbacks `fit`
makes, and the listeners the reference ships with them. `fit` calls
`on_fit_start`, then per epoch `on_epoch_start`, `iteration_done` after
every step (with that step's iteration, the epoch, the score and
`batch_size`, `etl_ms` and `batch` as keywords) and `on_epoch_end`,
then `on_fit_end`.

`PerformanceListener(sync=True)` waits for the card
(`torch.cuda.synchronize`) before each timestamp, as the JAX listener
blocks on the params: without it the window brackets the host's
enqueueing, not the device's work. The JAX package's telemetry hooks
(`monitor.extra_listeners`, the `EvaluativeListener` registry gauges)
are not ported.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, List, Optional

import torch

log = logging.getLogger("deeplearning4j_tpu_torch")


class TrainingListener:
    def iteration_done(self, model, iteration: int, epoch: int,
                       score: float, **info):
        pass

    def on_epoch_start(self, model, epoch: int):
        pass

    def on_epoch_end(self, model, epoch: int):
        pass

    def on_fit_start(self, model):
        pass

    def on_fit_end(self, model):
        pass


class ScoreIterationListener(TrainingListener):
    """Log the score every `print_iterations` iterations."""

    def __init__(self, print_iterations: int = 10,
                 printer: Callable[[str], None] = None):
        self.print_iterations = max(1, print_iterations)
        self.printer = printer or (lambda s: log.info(s))

    def iteration_done(self, model, iteration, epoch, score, **info):
        if iteration % self.print_iterations == 0:
            self.printer(f"Score at iteration {iteration} is {score}")


class PerformanceListener(TrainingListener):
    """Batches/sec, samples/sec and ETL time between iterations."""

    def __init__(self, frequency: int = 1, report_etl: bool = True,
                 printer: Callable[[str], None] = None, sync: bool = False):
        self.frequency = max(1, frequency)
        self.report_etl = report_etl
        self.sync = sync
        self.printer = printer or (lambda s: log.info(s))
        self._last_time: Optional[float] = None
        self.history: List[dict] = []

    def iteration_done(self, model, iteration, epoch, score, **info):
        device = getattr(model, "device", None)
        if self.sync and device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        if self._last_time is not None and iteration % self.frequency == 0:
            dt = now - self._last_time
            batch = info.get("batch_size", 0)
            # dt == 0 (timer resolution) emits 0.0, not inf (not JSON)
            rec = {
                "iteration": iteration,
                "batches_per_sec": 1.0 / dt if dt > 0 else 0.0,
                "samples_per_sec": batch / dt if dt > 0 else 0.0,
                "etl_ms": info.get("etl_ms", 0.0),
            }
            self.history.append(rec)
            msg = (f"iteration {iteration}; iterations/sec: "
                   f"{rec['batches_per_sec']:.3f}; samples/sec: "
                   f"{rec['samples_per_sec']:.1f}")
            if self.report_etl:
                msg += f"; ETL: {rec['etl_ms']:.1f} ms"
            self.printer(msg)
        self._last_time = now


class CollectScoresListener(TrainingListener):
    """Accumulates (iteration, score) pairs."""

    def __init__(self, frequency: int = 1):
        self.frequency = max(1, frequency)
        self.scores: List[tuple] = []

    def iteration_done(self, model, iteration, epoch, score, **info):
        if iteration % self.frequency == 0:
            self.scores.append((iteration, float(score)))


class TimeIterationListener(TrainingListener):
    """ETA logging against an expected iteration count."""

    def __init__(self, total_iterations: int, frequency: int = 50,
                 printer: Callable[[str], None] = None):
        self.total = total_iterations
        self.frequency = max(1, frequency)
        self.printer = printer or (lambda s: log.info(s))
        self._start = None

    def iteration_done(self, model, iteration, epoch, score, **info):
        if self._start is None:
            self._start = time.perf_counter()
            return
        if iteration % self.frequency == 0 and iteration > 0:
            elapsed = time.perf_counter() - self._start
            rate = iteration / elapsed
            remaining = ((self.total - iteration) / rate if rate > 0
                         else float("inf"))
            self.printer(f"iteration {iteration}/{self.total}; ETA "
                         f"{remaining:.0f}s")


class EvaluativeListener(TrainingListener):
    """`model.evaluate(iterator)` at every `frequency`-th epoch end
    (invocation "epoch_end") or iteration ("iteration_end")."""

    def __init__(self, iterator, frequency: int = 1,
                 invocation: str = "epoch_end",
                 printer: Callable[[str], None] = None, tag: str = "eval"):
        self.iterator = iterator
        self.frequency = max(1, frequency)
        self.invocation = invocation
        self.printer = printer or (lambda s: log.info(s))
        self.tag = tag
        self.evaluations: List = []
        self._last_iteration = 0

    def _evaluate(self, model, when):
        e = model.evaluate(self.iterator)
        self.evaluations.append(e)
        self.printer(f"[{when}] accuracy={e.accuracy():.4f} "
                     f"f1={e.f1():.4f}")

    def iteration_done(self, model, iteration, epoch, score, **info):
        self._last_iteration = iteration
        if (self.invocation == "iteration_end"
                and iteration % self.frequency == 0):
            self._evaluate(model, f"iter {iteration}")

    def on_epoch_end(self, model, epoch):
        if self.invocation == "epoch_end" and epoch % self.frequency == 0:
            self._evaluate(model, f"epoch {epoch}")


class ComposedListeners(TrainingListener):
    """Fans every callback out to `listeners`, in order."""

    def __init__(self, listeners):
        self.listeners = [l for l in (listeners or []) if l is not None]

    def iteration_done(self, *a, **k):
        for l in self.listeners:
            l.iteration_done(*a, **k)

    def on_epoch_start(self, *a, **k):
        for l in self.listeners:
            l.on_epoch_start(*a, **k)

    def on_epoch_end(self, *a, **k):
        for l in self.listeners:
            l.on_epoch_end(*a, **k)

    def on_fit_start(self, *a, **k):
        for l in self.listeners:
            l.on_fit_start(*a, **k)

    def on_fit_end(self, *a, **k):
        for l in self.listeners:
            l.on_fit_end(*a, **k)
