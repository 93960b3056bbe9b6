"""EarlyStoppingTrainer (counterpart of
`deeplearning4j_tpu/earlystopping/trainer.py`): an epoch loop that
scores on held-out data every N epochs, keeps the best model and stops
on the termination conditions (the iteration conditions through a
listener). With a `checkpointer` the full training state, the
trackers and the best model's arrays are checkpointed after every
scored epoch, in the JAX package's layout, so `fit(resume=True)` picks
an interrupted run up where it stopped."""

from __future__ import annotations

import math
from typing import Optional

from deeplearning4j_tpu_torch.earlystopping.config import (
    EarlyStoppingConfiguration,
    EarlyStoppingResult,
    TerminationReason,
)
from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener


class _IterationGuard(TrainingListener):
    def __init__(self, conditions):
        self.conditions = conditions
        self.triggered: Optional[str] = None

    def iteration_done(self, model, iteration, epoch, score, **info):
        if self.triggered:
            return
        for c in self.conditions:
            if c.terminate(score):
                self.triggered = str(c)


class EarlyStoppingTrainer:
    def __init__(self, config: EarlyStoppingConfiguration, model, train_data,
                 checkpointer=None, *, device="cuda"):
        """`checkpointer`: an AsyncCheckpointer or a directory path,
        optional. `device` is where the training runs; the model must
        live there (the default is the card)."""
        from deeplearning4j_tpu_torch.device import resolve_device
        if resolve_device(device) != model.device:
            raise ValueError(f"the model lives on {model.device}; an "
                             f"EarlyStoppingTrainer on {device} cannot "
                             f"train it")
        self.config = config
        self.model = model
        self.train_data = train_data
        if checkpointer is not None:
            from deeplearning4j_tpu_torch.fault import AsyncCheckpointer
            if not isinstance(checkpointer, AsyncCheckpointer):
                checkpointer = AsyncCheckpointer(checkpointer)
        self.checkpointer = checkpointer

    # --------------------------------------------------- fault persistence
    def _capture_best(self):
        """Host copies of the current (new best) model's arrays."""
        from deeplearning4j_tpu_torch.fault import state as fs
        return fs.model_arrays(self._net)

    def _save_checkpoint(self, epoch, best_score, best_epoch,
                         score_vs_epoch, best_arrays):
        from deeplearning4j_tpu_torch.fault import capture_training_state
        state = capture_training_state(
            self._net,
            iterator=(self.train_data
                      if hasattr(self.train_data, "cursor") else None),
            extra_meta={"earlystopping": {
                "epoch": epoch,
                "best_score": (None if math.isinf(best_score)
                               else float(best_score)),
                "best_epoch": best_epoch,
                "epochs_since_best": epoch - best_epoch,
                "score_vs_epoch": {str(k): float(v)
                                   for k, v in score_vs_epoch.items()},
            }})
        # the best arrays ride every checkpoint: retention may delete the
        # one where the best was first recorded, and resume reads only
        # the newest valid one
        if best_arrays is not None:
            state["arrays"]["es_best"] = best_arrays
        self.checkpointer.save(state, int(self.model.iteration_count))

    @property
    def _net(self):
        """The container itself (a parallel trainer wraps it)."""
        return getattr(self.model, "_model", self.model)

    def _model_from_arrays(self, arrays):
        from deeplearning4j_tpu_torch.fault import state as fs
        net = self._net
        m = fs.build_model({"model_type": type(net).__name__,
                            "configuration": net.conf.to_dict(),
                            "dtype_policy": net.dtype.to_dict()},
                           device=net.device)
        fs.load_arrays(m, arrays)
        return m

    def fit(self, resume: bool = False) -> EarlyStoppingResult:
        cfg = self.config
        for c in cfg.epoch_termination_conditions:
            c.initialize()
        for c in cfg.iteration_termination_conditions:
            c.initialize()
        guard = _IterationGuard(cfg.iteration_termination_conditions)
        self.model.listeners = list(self.model.listeners) + [guard]

        best_score, best_epoch = math.inf, -1
        best_arrays = None
        score_vs_epoch = {}
        epoch = 0
        if resume:
            if self.checkpointer is None:
                raise ValueError(
                    "fit(resume=True) needs a checkpointer; construct "
                    "EarlyStoppingTrainer(..., checkpointer=dir)")
            from deeplearning4j_tpu_torch.fault import (
                load_latest_valid,
                restore_training_state,
            )
            try:
                state, _ = load_latest_valid(self.checkpointer.directory)
            except FileNotFoundError:
                state = None      # nothing saved yet: cold start
            if state is not None:
                restore_training_state(self._net, state)
                es = state["meta"].get("earlystopping") or {}
                if es.get("best_score") is not None:
                    best_score = float(es["best_score"])
                best_epoch = int(es.get("best_epoch", -1))
                score_vs_epoch = {int(k): v for k, v in
                                  (es.get("score_vs_epoch") or {}).items()}
                epoch = int(es.get("epoch", -1)) + 1
                # the checkpoint was taken at an epoch's end: the
                # iterator continues at the next pass of the same
                # shuffle stream
                cur = state["meta"].get("iterator")
                if cur is not None:
                    try:
                        self.train_data.seek({"epoch": epoch, "batch": 0,
                                              "seed": cur.get("seed"),
                                              "shuffle": cur.get("shuffle")})
                    except NotImplementedError:
                        pass   # source without the position contract
                best_arrays = state["arrays"].get("es_best")
                if best_arrays is not None and cfg.model_saver:
                    cfg.model_saver.save_best_model(
                        self._model_from_arrays(best_arrays), best_score)
        reason = TerminationReason.MAX_EPOCHS
        details = "no termination condition triggered"
        while True:
            self.model.fit(self.train_data, epochs=1)
            if guard.triggered:
                reason = TerminationReason.ITERATION_TERMINATION
                details = guard.triggered
                break
            if epoch % cfg.evaluate_every_n_epochs == 0:
                score = (cfg.score_calculator.calculate_score(self.model)
                         if cfg.score_calculator else self.model.score())
                score_vs_epoch[epoch] = score
                if score < best_score:
                    best_score, best_epoch = score, epoch
                    if cfg.model_saver:
                        cfg.model_saver.save_best_model(self.model, score)
                    if self.checkpointer is not None:
                        best_arrays = self._capture_best()
                if cfg.save_last_model and cfg.model_saver:
                    cfg.model_saver.save_latest_model(self.model, score)
                if self.checkpointer is not None:
                    self._save_checkpoint(epoch, best_score, best_epoch,
                                          score_vs_epoch, best_arrays)
            stop = False
            last = score_vs_epoch.get(epoch, self.model.score())
            for c in cfg.epoch_termination_conditions:
                if c.terminate(epoch, last):
                    reason = TerminationReason.EPOCH_TERMINATION
                    details = str(c)
                    stop = True
                    break
            if stop:
                break
            epoch += 1

        if self.checkpointer is not None:
            self.checkpointer.wait()   # durable before reporting done
        if cfg.model_saver and best_epoch >= 0:
            best_model = cfg.model_saver.get_best_model()
        elif best_arrays is not None and best_epoch >= 0:
            # no saver configured but the checkpointer kept the best
            # arrays (a resumed run's best may predate this process)
            best_model = self._model_from_arrays(best_arrays)
        else:
            best_model = self._net
        self.model.listeners = [l for l in self.model.listeners if l is not guard]
        return EarlyStoppingResult(
            termination_reason=reason,
            termination_details=details,
            score_vs_epoch=score_vs_epoch,
            best_model_epoch=best_epoch,
            best_model_score=best_score,
            total_epochs=epoch + 1,
            best_model=best_model,
        )


# graph models use the same trainer
EarlyStoppingGraphTrainer = EarlyStoppingTrainer


class EarlyStoppingParallelTrainer(EarlyStoppingTrainer):
    """Early stopping over data-parallel training (the JAX
    `EarlyStoppingParallelTrainer`): each epoch runs through a
    `ParallelTrainer` on `mesh` instead of the container's `fit`;
    scoring, saving and termination are the base trainer's."""

    def __init__(self, config, model, train_data, mesh=None, *,
                 mode: str = "sync", averaging_frequency: int = 5,
                 batch_size: int = 32, checkpointer=None):
        super().__init__(config, model, train_data, checkpointer,
                         device=model.device)
        from deeplearning4j_tpu_torch.parallel.trainer import ParallelTrainer
        self._trainer = ParallelTrainer(
            model, mesh, mode=mode, averaging_frequency=averaging_frequency)
        self._batch_size = batch_size
        self.model = _ParallelFitAdapter(model, self._trainer, batch_size)


class _ParallelFitAdapter:
    """The wrapped container, with `fit` going through the
    ParallelTrainer (so the base trainer's loop is unchanged)."""

    def __init__(self, model, trainer, batch_size):
        self._model = model
        self._trainer = trainer
        self._batch_size = batch_size

    def fit(self, data, epochs=1, **kw):
        self._trainer.fit(data, epochs=epochs,
                          batch_size=kw.get("batch_size", self._batch_size))
        return self._model

    def __getattr__(self, name):
        return getattr(self._model, name)

    @property
    def listeners(self):
        return self._model.listeners

    @listeners.setter
    def listeners(self, v):
        self._model.listeners = v

