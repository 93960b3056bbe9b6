"""OnlineTrainer: continuous training that publishes into the fleet
(counterpart of `deeplearning4j_tpu/online/trainer.py`: `DriftGate` :36,
`_StopAfterListener` :184, `OnlineTrainer` :202, `resume` :342).

An unbounded `StreamingDataSetIterator` drives the ordinary
`MultiLayerNetwork.fit` loop (one epoch that ends when the stream
quiesces, `stop()` is called or `max_steps` completes), so every fit-loop
contract holds without new step code: `step_boundary` gates the
checkpoint and publish listeners, the diagnostics cadence runs unchanged,
and the fault runtime checkpoints the whole state, the stream cursor and
the live normalizer window included (and an attached adapter: a tenant's
online loop trains and publishes its LoRA factors through
`AdapterPublishListener`, passed in `listeners`).

Drift-aware gating (`DriftGate`): an `EvaluativeListener` tap on a
held-out stream feeds the `evaluative_score{tag=,metric=}` gauges; when
the held-out score moves past a band from the best seen, the gate trips,
which pauses PUBLISHING (the registry listener skips its cadence without
advancing its clock) but never training, and publishing resumes at the
first boundary after the score recovers into the band.
`online_publish_paused` / `online_drift_trips_total` are the alarms.
"""


from __future__ import annotations

import logging
from typing import Callable, List, Optional

from deeplearning4j_tpu_torch.optimize.listeners import (
    EvaluativeListener,
    TrainingListener,
)

log = logging.getLogger("deeplearning4j_tpu_torch.online")


class DriftGate(EvaluativeListener):
    """Held-out-score regression gate over the EvaluativeListener tap.

    Evaluates the held-out iterator every `frequency` iterations
    (iteration_end invocation — an unbounded run has no epoch ends);
    tracks the best score seen and trips when the current score falls
    below ``best - band``. `allow_publish()` is the gate callable the
    registry publish listener consults; `paused` flips back to False
    the moment the score recovers into the band. Training itself is
    never touched.

    ``metric="loss"`` is the LOSS-BAND mode: the held-out LOSS (mean
    per-example `model.score`, masked-example aware through the loss
    fn) replaces the classification score, best is the MINIMUM seen,
    and the gate trips when loss RISES past ``best + band`` — which is
    what regression and LM-perplexity online loops gate on, where
    accuracy/f1 mean nothing."""

    def __init__(self, heldout, *, frequency: int = 50,
                 band: float = 0.1, metric: str = "accuracy",
                 min_evals_before_gating: int = 1, tag: str = "heldout",
                 printer: Optional[Callable[[str], None]] = None):
        super().__init__(heldout, frequency=frequency,
                         invocation="iteration_end", tag=tag,
                         printer=printer or (lambda s: log.info(s)))
        if band <= 0:
            raise ValueError(f"band must be > 0, got {band}")
        if metric not in ("accuracy", "f1", "loss"):
            raise ValueError(
                f"metric must be 'accuracy', 'f1' or 'loss'; "
                f"got {metric!r}")
        self.metric = metric
        self.band = float(band)
        self.min_evals_before_gating = int(min_evals_before_gating)
        self.best_score: Optional[float] = None
        self.last_score: Optional[float] = None
        self.paused = False
        self.trips = 0
        self.history: List[tuple] = []    # (iteration, score, paused)
        self._evals = 0
        self._metrics_cache = None

    # ----------------------------------------------------------- scoring
    def _current_score(self, evaluation) -> float:
        if self.metric == "f1":
            return float(evaluation.f1())
        return float(evaluation.accuracy())

    def _gate_metrics(self):
        from deeplearning4j_tpu_torch import monitor
        return monitor.resolve_cached_metrics(
            self, "_metrics_cache", lambda reg: {
                "paused": reg.gauge(
                    "online_publish_paused",
                    "1 while the drift gate is refusing publishes",
                    tag=self.tag),
                "trips": reg.counter(
                    "online_drift_trips_total",
                    "held-out regressions that tripped the publish "
                    "gate", tag=self.tag),
            })

    def _heldout_loss(self, model) -> float:
        """Example-weighted mean loss over the held-out iterator (or a
        single DataSet) through `model.score` — the exact training
        objective, so the band compares like against like."""
        import numpy as np

        it = self.iterator
        if hasattr(it, "features"):            # a bare DataSet
            batches = [it]
        else:
            if hasattr(it, "reset"):
                it.reset()
            batches = it
        total, n = 0.0, 0
        for ds in batches:
            b = int(np.asarray(ds.features).shape[0])
            total += float(model.score(ds)) * b
            n += b
        if n == 0:
            raise ValueError("held-out iterator yielded no examples")
        return total / n

    def _evaluate(self, model, when):
        loss_mode = self.metric == "loss"
        if loss_mode:
            score = self._heldout_loss(model)
            self.printer(f"[{when}] heldout loss={score:.4f}")
            from deeplearning4j_tpu_torch import monitor
            if monitor.is_enabled():
                reg = monitor.registry()
                reg.gauge("evaluative_score",
                          help="held-out evaluation score from "
                               "EvaluativeListener",
                          tag=self.tag, metric="loss").set(float(score))
                reg.gauge("evaluative_last_iteration",
                          help="iteration of the last held-out "
                               "evaluation",
                          tag=self.tag).set(float(self._last_iteration))
        else:
            super()._evaluate(model, when)
            score = self._current_score(self.evaluations[-1])
        self.last_score = score
        self._evals += 1
        better = (score < self.best_score if loss_mode
                  else score > self.best_score) \
            if self.best_score is not None else True
        if better:
            self.best_score = score
        degraded = (score > self.best_score + self.band if loss_mode
                    else score < self.best_score - self.band)
        if (degraded and not self.paused
                and self._evals >= self.min_evals_before_gating):
            self.paused = True
            self.trips += 1
            from deeplearning4j_tpu_torch.monitor.flightrec import (
                GLOBAL_FLIGHT_RECORDER,
            )
            GLOBAL_FLIGHT_RECORDER.record(
                "drift_trip", tag=self.tag, metric=self.metric,
                score=float(score), best=float(self.best_score),
                band=float(self.band),
                iteration=int(self._last_iteration))
            log.warning(
                "drift gate TRIPPED at %s: held-out %s %.4f moved more "
                "than %.3f past best %.4f — publishing paused "
                "(training continues)", when, self.metric, score,
                self.band, self.best_score)
            m = self._gate_metrics()
            if m is not None:
                m["trips"].inc()
        elif self.paused and not degraded:
            self.paused = False
            log.info(
                "drift gate recovered at %s: held-out %s %.4f back "
                "inside the band — publishing resumes", when,
                self.metric, score)
        self.history.append((self._last_iteration, score, self.paused))
        m = self._gate_metrics()
        if m is not None:
            m["paused"].set(1.0 if self.paused else 0.0)

    # -------------------------------------------------------------- gate
    def allow_publish(self) -> bool:
        return not self.paused


class _StopAfterListener(TrainingListener):
    """Ends the unbounded stream after `max_steps` completed
    iterations by asking the ITERATOR to stop — the fit loop then
    finishes the epoch naturally (flushing any pending fused group and
    firing on_epoch_end/on_fit_end), so the publish/checkpoint
    listeners see an ordinary end-of-fit at an arbitrary step."""

    def __init__(self, iterator, max_steps: int):
        self.iterator = iterator
        self.max_steps = int(max_steps)

    def iteration_done(self, model, iteration, epoch, score, **info):
        if iteration + 1 >= self.max_steps:
            stop = getattr(self.iterator, "stop", None)
            if stop is not None:
                stop()


class OnlineTrainer:
    """Continuous fine-tuning from a streaming iterator, publishing
    snapshots into a `ModelRegistry` and checkpointing through the
    fault runtime.

    ``trainer.run()`` blocks until the stream quiesces (watermark
    timeout), `stop()` is called, or `max_steps` completes; it returns
    a summary dict. Resume an interrupted run with
    `OnlineTrainer.resume(directory, ...)` — the checkpoint cursor
    seeks the (replayable) transport back to the exact record after
    the last trained batch, and the restored counters pin the rng
    stream, so the resumed trajectory is bit-equal to an uninterrupted
    run over the same record sequence."""

    def __init__(self, net, iterator, *, registry=None,
                 model_name: Optional[str] = None,
                 publish_frequency: int = 100,
                 publish_at_fit_end: bool = True,
                 save_updater: bool = False,
                 checkpoint_dir=None, checkpoint_frequency: int = 50,
                 checkpoint_at_fit_end: bool = True,
                 normalizer=None, drift_gate: Optional[DriftGate] = None,
                 steps_per_execution: int = 1,
                 listeners=()):
        if (registry is None) != (model_name is None):
            raise ValueError(
                "registry and model_name come together (both or "
                "neither)")
        self.net = net
        self.iterator = iterator
        self.registry = registry
        self.model_name = model_name
        self.publish_frequency = int(publish_frequency)
        self.publish_at_fit_end = publish_at_fit_end
        self.save_updater = save_updater
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_frequency = int(checkpoint_frequency)
        self.checkpoint_at_fit_end = checkpoint_at_fit_end
        self.normalizer = normalizer
        self.drift_gate = drift_gate
        self.steps_per_execution = int(steps_per_execution)
        self.extra_listeners = list(listeners)
        self.publish_listener = None
        self.checkpoint_listener = None
        # streaming iterators transform through the SAME normalizer the
        # checkpoints persist — wire it if the iterator has the slot
        # and nothing is set yet (explicit wiring wins)
        if (normalizer is not None
                and getattr(iterator, "normalizer", "absent") is None):
            iterator.normalizer = normalizer

    # ---------------------------------------------------------- assembly
    def _build_listeners(self, max_steps: Optional[int]):
        ls: List[TrainingListener] = []
        if self.registry is not None:
            gate = (self.drift_gate.allow_publish
                    if self.drift_gate is not None else None)
            normalizer_provider = None
            if self.normalizer is not None:
                snap = getattr(self.normalizer, "snapshot", None)
                normalizer_provider = snap if snap is not None \
                    else (lambda: self.normalizer)
            self.publish_listener = self.registry.publish_listener(
                self.model_name, frequency=self.publish_frequency,
                save_updater=self.save_updater,
                publish_at_fit_end=self.publish_at_fit_end,
                gate=gate, normalizer_provider=normalizer_provider)
            ls.append(self.publish_listener)
        if self.checkpoint_dir is not None:
            from deeplearning4j_tpu_torch.fault.listener import (
                CheckpointListener)
            self.checkpoint_listener = CheckpointListener(
                self.checkpoint_dir,
                frequency=self.checkpoint_frequency,
                iterator=self.iterator, normalizer=self.normalizer,
                save_at_fit_end=self.checkpoint_at_fit_end)
            ls.append(self.checkpoint_listener)
        if self.drift_gate is not None:
            ls.append(self.drift_gate)
        if max_steps is not None:
            completed = int(self.net.iteration_count)
            ls.append(_StopAfterListener(self.iterator,
                                         completed + int(max_steps)))
        ls.extend(self.extra_listeners)
        return ls

    # --------------------------------------------------------------- run
    def run(self, max_steps: Optional[int] = None) -> dict:
        """Train until the stream ends. `max_steps` bounds the number
        of FURTHER iterations (on top of any already-restored
        counters); None streams until quiescence/stop()."""
        run_listeners = self._build_listeners(max_steps)
        added = []
        for l in run_listeners:
            self.net.add_listener(l)
            added.append(l)
        start_it = int(self.net.iteration_count)
        try:
            self.net.fit(self.iterator, epochs=1,
                         steps_per_execution=self.steps_per_execution)
        finally:
            for l in added:
                try:
                    self.net.listeners.remove(l)
                except ValueError:
                    pass
        return self.summary(start_iteration=start_it)

    def stop(self):
        """Ask the stream to end at the next batch boundary; `run()`
        returns after the fit loop drains (final checkpoint + final
        publish included)."""
        stop = getattr(self.iterator, "stop", None)
        if stop is not None:
            stop()

    def summary(self, *, start_iteration: int = 0) -> dict:
        out = {
            "iterations": int(self.net.iteration_count) - start_iteration,
            "iteration_count": int(self.net.iteration_count),
            "score": float(getattr(self.net, "score_value", float("nan"))),
        }
        if self.publish_listener is not None:
            out["published_versions"] = list(
                self.publish_listener.published_versions)
            out["published_steps"] = list(
                self.publish_listener.published_steps)
            out["publishes_gated"] = self.publish_listener.gated_skips
        if self.drift_gate is not None:
            out["drift_trips"] = self.drift_gate.trips
            out["publish_paused"] = self.drift_gate.paused
            out["heldout_best"] = self.drift_gate.best_score
            out["heldout_last"] = self.drift_gate.last_score
        cur = getattr(self.iterator, "cursor", lambda: None)()
        if cur is not None:
            out["cursor"] = cur
        return out

    # ------------------------------------------------------------ resume
    @classmethod
    def resume(cls, directory, iterator, *, net=None, device="cuda", **kw
               ) -> "OnlineTrainer":
        """Rebuild an OnlineTrainer from the newest valid checkpoint
        under `directory`: the model (rebuilt from the stored
        configuration unless `net` is passed), counters (which pin the
        per-step rng stream), the live normalizer WINDOW, and the
        stream position — `iterator` is seeked to the checkpoint
        cursor, so over a replayable transport the next batch read is
        the exact record sequence the interrupted run would have
        trained next. A model built here lives on `device`; an attached
        adapter in the checkpoint is attached again. Keyword args are the
        OnlineTrainer constructor's (checkpoint_dir defaults to
        `directory` so the resumed run keeps checkpointing in place)."""
        from deeplearning4j_tpu_torch.fault.resume import load_latest_valid
        from deeplearning4j_tpu_torch.fault.state import (
            build_model,
            restore_normalizer,
            restore_training_state,
        )
        state, step = load_latest_valid(directory)
        model = (net if net is not None
                 else build_model(state["meta"], device=device))
        restore_training_state(model, state, iterator=iterator)
        normalizer = kw.pop("normalizer", None)
        restored_norm = restore_normalizer(state)
        if restored_norm is not None:
            normalizer = restored_norm
        # the monitor restore counters mirror fault.resume's
        from deeplearning4j_tpu_torch import monitor
        if monitor.is_enabled():
            monitor.registry().counter(
                "restore_total",
                help="successful training-state restores").inc()
            monitor.registry().gauge(
                "restore_last_step",
                help="step of the last restored checkpoint").set(step)
        if (normalizer is not None
                and getattr(iterator, "normalizer", "absent") is None):
            iterator.normalizer = normalizer
        kw.setdefault("checkpoint_dir", directory)
        log.info("online trainer resumed at step %d from %s", step,
                 directory)
        return cls(model, iterator, normalizer=normalizer, **kw)
