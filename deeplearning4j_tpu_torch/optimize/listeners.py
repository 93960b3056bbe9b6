"""Training listeners (counterpart of
`deeplearning4j_tpu/optimize/listeners.py` :19-220, with
`SleepyTrainingListener` :205): the callbacks `fit`
makes, and the listeners the reference ships with them. `fit` calls
`on_fit_start`, then per epoch `on_epoch_start`, `iteration_done` after
every step (with that step's iteration, the epoch, the score and
`batch_size`, `etl_ms` and `batch` as keywords) and `on_epoch_end`,
then `on_fit_end`.

`PerformanceListener(sync=True)` waits for the card
(`torch.cuda.synchronize`) before each timestamp, as the JAX listener
blocks on the params: without it the window brackets the host's
enqueueing, not the device's work.

Telemetry: while `monitor` is enabled, `EvaluativeListener` publishes
its scores as registry gauges (the JAX :150-165);
`ParamAndGradientIterationListener` prints the diagnostics' per-param
magnitudes (the training gradients the updater consumed); and
`ProfilerListener` wraps chosen iterations in `torch.profiler`, the
counterpart of the JAX listener's `jax.profiler` trace.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, List, Optional

import numpy as np
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
        acc, f1 = e.accuracy(), e.f1()
        self.printer(f"[{when}] accuracy={acc:.4f} f1={f1:.4f}")
        from deeplearning4j_tpu_torch import monitor
        if monitor.is_enabled():
            reg = monitor.registry()
            for metric, v in (("accuracy", acc), ("f1", f1)):
                reg.gauge("evaluative_score",
                          help="held-out evaluation score from "
                               "EvaluativeListener",
                          tag=self.tag, metric=metric).set(float(v))
            reg.gauge("evaluative_last_iteration",
                      help="iteration of the last held-out evaluation",
                      tag=self.tag).set(float(self._last_iteration))

    def iteration_done(self, model, iteration, epoch, score, **info):
        self._last_iteration = iteration
        if (self.invocation == "iteration_end"
                and iteration % self.frequency == 0):
            self._evaluate(model, f"iter {iteration}")

    def on_epoch_end(self, model, epoch):
        if self.invocation == "epoch_end" and epoch % self.frequency == 0:
            self._evaluate(model, f"epoch {epoch}")


class ParamAndGradientIterationListener(TrainingListener):
    """Per-iteration param and gradient magnitudes (reference
    `ParamAndGradientIterationListener.java`, the JAX :255-285).

    The gradient magnitudes come from the diagnostics of the train step
    (``info["diagnostics"]``, else ``model._last_diagnostics``): the
    training gradients the updater consumed. Without diagnostics the
    listener prints the params' mean |.| only (one batched readback) and
    says once how to turn the gradients on."""

    def __init__(self, print_iterations: int = 1, printer=None,
                 print_gradients: bool = True):
        self.print_iterations = max(1, print_iterations)
        self.print_gradients = print_gradients
        self.printer = printer or (lambda s: log.info(s))
        self._warned_no_diag = False

    def iteration_done(self, model, iteration, epoch, score, **info):
        if iteration % self.print_iterations != 0:
            return
        # an explicit diagnostics=None is an off-cadence step: print the
        # params only rather than relabel a stale readback
        diag = (info["diagnostics"] if "diagnostics" in info
                else getattr(model, "_last_diagnostics", None))
        diag_params = (diag or {}).get("params") or {}
        parts = [f"iter {iteration} score {score:.6g}"]
        if diag_params:
            for key in sorted(diag_params):
                st = diag_params[key]
                msg = f"{key}: |p|={st['param_mm']:.4g}"
                if self.print_gradients and "grad_mm" in st:
                    msg += f" |g|={st['grad_mm']:.4g}"
                parts.append(msg)
        else:
            if self.print_gradients and not self._warned_no_diag:
                self._warned_no_diag = True
                log.warning(
                    "ParamAndGradientIterationListener: model has no "
                    "diagnostics seam — gradient magnitudes unavailable; "
                    "build the model with diagnostics enabled (conf "
                    ".diagnostics(True) or DL4J_DIAGNOSTICS=1) to see "
                    "the training gradients")
            from deeplearning4j_tpu_torch.monitor.diagnostics import (
                batched_host_tree)
            host = batched_host_tree(
                {key: dict(layer.jax_param_map())
                 for key, layer in model.keyed() if layer.jax_param_map()})
            for lk, lparams in host.items():
                for pn, arr in lparams.items():
                    parts.append(f"{lk}_{pn}: |p|={np.abs(arr).mean():.4g}")
        self.printer(" | ".join(parts))


class ProfilerListener(TrainingListener):
    """Wraps chosen training iterations in a `torch.profiler` trace (the
    JAX listener's `jax.profiler` trace, :288-350): the trace starts
    after iteration ``start_iteration - 1`` and stops after
    `num_iterations` iterations, and is written as a Chrome trace JSON
    under `log_dir/<epoch tag>/`. One window per fit by default;
    `trace_every_epoch` re-arms it at each epoch start. CUDA activity is
    recorded when a card is present."""

    def __init__(self, log_dir: str, start_iteration: int = 1,
                 num_iterations: int = 3, trace_every_epoch: bool = False):
        import os
        self.log_dir = log_dir
        self.start_iteration = start_iteration
        self.num_iterations = max(1, num_iterations)
        self.trace_every_epoch = trace_every_epoch
        self._prof = None
        self._armed = True
        self._seen = 0
        self._epoch_dir = None
        os.makedirs(log_dir, exist_ok=True)

    def _start(self, tag: str):
        import os
        from torch.profiler import ProfilerActivity, profile
        self._epoch_dir = os.path.join(self.log_dir, tag)
        os.makedirs(self._epoch_dir, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._seen = 0

    def _stop(self):
        import os
        if self._prof is not None:
            prof, self._prof = self._prof, None
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(
                os.path.join(self._epoch_dir, "trace.json"))
            self._armed = False

    def on_epoch_start(self, model, epoch: int):
        if self.trace_every_epoch:
            self._armed = True

    def iteration_done(self, model, iteration, epoch, score, **info):
        if self._prof is not None:
            self._seen += 1
            if self._seen >= self.num_iterations:
                self._stop()
        elif self._armed and iteration + 1 >= self.start_iteration:
            self._start(f"epoch{epoch}_iter{iteration + 1}")

    def on_fit_end(self, model):
        self._stop()

    def trace_dirs(self):
        """The directories that hold a trace."""
        import os
        return [root for root, _, files in os.walk(self.log_dir)
                if any(f.endswith(".json") for f in files)]


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


class SleepyTrainingListener(TrainingListener):
    """Sleeps `timer_iteration_ms` after every step and `timer_epoch_ms`
    after every epoch: a debugging aid for schedulers and timeouts, not
    for production."""

    def __init__(self, timer_iteration_ms: float = 0.0,
                 timer_epoch_ms: float = 0.0):
        self.timer_iteration_ms = timer_iteration_ms
        self.timer_epoch_ms = timer_epoch_ms

    def iteration_done(self, model, iteration, epoch, score, **info):
        if self.timer_iteration_ms > 0:
            time.sleep(self.timer_iteration_ms / 1e3)

    def on_epoch_end(self, model, epoch):
        if self.timer_epoch_ms > 0:
            time.sleep(self.timer_epoch_ms / 1e3)
