"""The training-listener bridge onto the metrics registry (counterpart of
`deeplearning4j_tpu/monitor/listener.py`).

`MonitorListener` rides the `TrainingListener` bus both containers fan
out to (`optimize/listeners.py`), turning iteration and epoch callbacks
into registry counters, gauges and histograms. While monitoring is on,
`fit` attaches one itself (`monitor.extra_listeners()`), so any fit
feeds `/metrics` without a change at the call site.

`bind_master_stats` hooks a `TrainingMasterStats` (the parallel
trainers' per-phase timing, `parallel/stats.py`) onto a registry and a
tracer; `record_master_event` lands one phase event there
(`parallel_phase_total`, `parallel_phase_seconds`, `master/<phase>`
spans).
"""

from __future__ import annotations

from typing import Optional

from deeplearning4j_tpu_torch.monitor.registry import MetricsRegistry
from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener


class MonitorListener(TrainingListener):
    """TrainingListener -> MetricsRegistry adapter: host arithmetic on
    values the fit loop already has, no device sync."""

    def __init__(self, registry: MetricsRegistry, model_label: str = "default"):
        self.registry = registry
        self.model_label = model_label

    def iteration_done(self, model, iteration, epoch, score, **info):
        reg = self.registry
        lbl = {"model": self.model_label}
        reg.counter("training_iterations_total",
                    help="fit iterations completed", **lbl).inc()
        batch = info.get("batch_size", 0)
        if batch:
            reg.counter("training_examples_total",
                        help="examples trained", **lbl).inc(float(batch))
        score = float(score)
        if score == score:  # skip NaN (score not read back this step)
            reg.gauge("training_score", help="last minibatch loss",
                      **lbl).set(score)
        etl_ms = info.get("etl_ms")
        if etl_ms:
            reg.histogram("training_etl_seconds",
                          help="dataset ETL time per batch",
                          **lbl).observe(float(etl_ms) / 1e3)

    def on_epoch_end(self, model, epoch):
        self.registry.counter("training_epochs_total",
                              help="fit epochs completed",
                              model=self.model_label).inc()

    def on_fit_start(self, model):
        self.registry.counter("training_fits_total",
                              help="fit() calls started",
                              model=self.model_label).inc()


def record_master_event(ev, registry: MetricsRegistry, tracer=None,
                        t0_perf: Optional[float] = None):
    """Land one `TrainingMasterStats` phase event in the registry (and
    the tracer). With `t0_perf`, the stats object's `perf_counter` epoch,
    the span sits on the tracer's timeline beside the fit spans;
    without, on the event's own relative clock."""
    phase = ev.get("phase", "unknown")
    dur_s = ev.get("duration_ms", 0.0) / 1e3
    registry.counter("parallel_phase_total",
                     help="distributed-training phase occurrences",
                     phase=phase).inc()
    registry.timer("parallel_phase_seconds",
                   help="distributed-training phase durations",
                   phase=phase).observe(dur_s)
    if tracer is not None:
        extra = {k: v for k, v in ev.items()
                 if k not in ("phase", "start_ms", "duration_ms")}
        if t0_perf is not None:
            start = t0_perf + ev.get("start_ms", 0.0) / 1e3
            tracer.complete_between(f"master/{phase}", start, start + dur_s,
                                    **extra)
        else:
            tracer.add_complete_event(
                f"master/{phase}", ev.get("start_ms", 0.0) / 1e3, dur_s,
                **extra)


def bind_master_stats(stats, registry: MetricsRegistry, tracer=None):
    """Route every `TrainingMasterStats` phase event onto the registry
    (and the tracer). Returns `stats` for chaining."""
    t0_perf = getattr(stats, "_t0", None)

    def on_event(ev):
        record_master_event(ev, registry, tracer, t0_perf)

    stats.add_listener(on_event)
    return stats
