"""The training-listener bridge onto the metrics registry (counterpart of
`deeplearning4j_tpu/monitor/listener.py`).

`MonitorListener` rides the `TrainingListener` bus both containers fan
out to (`optimize/listeners.py`), turning iteration and epoch callbacks
into registry counters, gauges and histograms. While monitoring is on,
`fit` attaches one itself (`monitor.extra_listeners()`), so any fit
feeds `/metrics` without a change at the call site.

`bind_master_stats` (the parallel trainers' per-phase timing) waits for
the parallel trainers and raises until they are ported.
"""

from __future__ import annotations

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


def bind_master_stats(stats, registry: MetricsRegistry, tracer=None):
    """The parallel trainers' phase events onto the registry: not ported
    until `parallel/trainer.py` is."""
    raise NotImplementedError(
        "bind_master_stats needs the parallel trainers' TrainingMasterStats "
        "(parallel/trainer.py), not ported yet (ROADMAP Queue 1 item 7)")
