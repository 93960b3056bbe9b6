"""TrainingMaster: the multi-node training strategy surface (counterpart
of `deeplearning4j_tpu/parallel/master.py`).

Both masters drive a `ParallelTrainer` on a mesh:
`ParameterAveragingTrainingMaster` its averaging mode (local steps,
then the replica mean every `averaging_frequency` steps) and
`SharedTrainingMaster` its per-step sync mode (the threshold
compression knobs of the reference's parameter server are accepted and
logged as unused, as in JAX). `batch_size_per_worker` times the data
axis is the global batch.

Fault tolerance is JAX's epoch loop: with `checkpoint_dir` or `max_retries`
one `fit` per epoch, a model zip (`util/serializer.py`) every
`checkpoint_every` epochs written to a temporary name and renamed, a
retry budget that restores the newest checkpoint (or the state before
the first epoch) after a failure, and a resume from the newest
checkpoint at start. JAX's fallback to its sharded Orbax checkpoint
when a zip cannot be gathered has no counterpart yet
(`util/sharded_checkpoint.py` comes with the multi-process trainers):
a zip that fails to write raises.
"""

from __future__ import annotations

import copy
import glob
import logging
import os
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.parallel.mesh import device_mesh
from deeplearning4j_tpu_torch.parallel.stats import TrainingMasterStats
from deeplearning4j_tpu_torch.parallel.trainer import ParallelTrainer

log = logging.getLogger(__name__)


class TrainingMaster:
    """`execute_training(model, data)`: `data` is a DataSetIterator, a
    DataSet, or an (x, y) pair."""

    def execute_training(self, model, data, *, epochs: int = 1):
        raise NotImplementedError

    @staticmethod
    def _split(data):
        if (isinstance(data, tuple) and len(data) == 2
                and not hasattr(data[0], "features")):
            return data[0], data[1]
        return data, None

    def execute_evaluation(self, model, data, *, batch_size: int = 32,
                           evaluation=None, n_shards: Optional[int] = None):
        """Distributed evaluation: the data split into worker shards,
        each scored through the mesh's forward into an emptied clone of
        the caller's evaluator, the clones combined with `merge` (an
        iterator or DataSet is scored in one pass)."""
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
        mesh = getattr(self, "mesh", None) or device_mesh()
        trainer = ParallelTrainer(model, mesh)
        x, y = self._split(data)
        merged = evaluation if evaluation is not None else Evaluation()
        if y is None:
            return trainer.evaluate(x, batch_size=batch_size,
                                    evaluation=merged)
        n = n_shards or mesh.shape["data"]
        n = max(1, min(n, len(x)))
        can_clone = hasattr(merged, "reset")
        for xs, ys in zip(np.array_split(np.asarray(x), n),
                          np.array_split(np.asarray(y), n)):
            if can_clone:
                shard_ev = copy.deepcopy(merged)
                shard_ev.reset()
                trainer.evaluate(xs, ys, batch_size=batch_size,
                                 evaluation=shard_ev)
                merged.merge(shard_ev)
            else:
                trainer.evaluate(xs, ys, batch_size=batch_size,
                                 evaluation=merged)
        return merged

    # -------------------------------------------------- fault tolerance
    def _run_epochs(self, model, trainer, x, y, *, epochs, batch_size):
        from deeplearning4j_tpu_torch.fault import state as fs
        from deeplearning4j_tpu_torch.util.serializer import ModelSerializer

        spe = max(1, getattr(self, "steps_per_execution", 1))
        ckpt_dir = getattr(self, "checkpoint_dir", None)
        every = max(0, getattr(self, "checkpoint_every", 0))
        retries = max(0, getattr(self, "max_retries", 0))
        if not ckpt_dir and not retries:
            return trainer.fit(x, y, epochs=epochs, batch_size=batch_size,
                               steps_per_execution=spe)

        # the state before the first epoch: what a failure restores when
        # no checkpoint exists yet (only taken when retries can use it)
        init_snap = None
        if retries:
            init_snap = (fs.model_arrays(model), model.iteration_count,
                         model.epoch_count)

        def restore_from(arrays, it, ep):
            fs.load_arrays(model, arrays)
            model.iteration_count, model.epoch_count = it, ep

        def _ckpt_epoch(path):
            return int(os.path.splitext(os.path.basename(path))[0][5:])

        def _list_ckpts():
            return sorted(glob.glob(os.path.join(ckpt_dir, "epoch*.zip")),
                          key=_ckpt_epoch)

        def _restore_ckpt(path):
            net = ModelSerializer.restore_model(path, device=model.device)
            restore_from(fs.model_arrays(net), net.iteration_count,
                         net.epoch_count)

        start_epoch = 0
        if ckpt_dir:
            os.makedirs(ckpt_dir, exist_ok=True)
            existing = _list_ckpts()
            if existing and getattr(self, "resume", True):
                latest = existing[-1]
                _restore_ckpt(latest)
                start_epoch = _ckpt_epoch(latest) + 1
                log.info("resuming from %s (epoch %d)", latest, start_epoch)

        def save(epoch):
            if ckpt_dir and every and (epoch + 1) % every == 0:
                base = os.path.join(ckpt_dir, f"epoch{epoch:05d}")
                tmp = base + ".zip.tmp"
                try:
                    ModelSerializer.write_model(model, tmp)
                    os.replace(tmp, base + ".zip")
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)

        epoch = start_epoch
        budget = retries
        while epoch < epochs:
            try:
                trainer.fit(x, y, epochs=1, batch_size=batch_size,
                            steps_per_execution=spe)
                save(epoch)
                epoch += 1
            except Exception:
                if budget <= 0:
                    raise
                budget -= 1
                existing = _list_ckpts() if ckpt_dir else []
                if existing:
                    _restore_ckpt(existing[-1])
                    epoch = _ckpt_epoch(existing[-1]) + 1
                    log.warning("failure; restored %s, resuming at epoch "
                                "%d (%d retries left)", existing[-1],
                                epoch, budget)
                else:
                    restore_from(*init_snap)
                    epoch = 0
                    log.warning("failure with no checkpoint yet; restored "
                                "the initial state, restarting from epoch "
                                "0 (%d retries left)", budget)
        return model


class ParameterAveragingTrainingMaster(TrainingMaster):
    def __init__(self, *, batch_size_per_worker: int = 32,
                 averaging_frequency: int = 5,
                 average_updater_state: bool = True, mesh=None,
                 collect_training_stats: bool = False,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 1, max_retries: int = 0,
                 resume: bool = True):
        self.batch_size_per_worker = batch_size_per_worker
        self.averaging_frequency = averaging_frequency
        self.average_updater_state = average_updater_state
        self.mesh = mesh
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.max_retries = max_retries
        self.resume = resume
        # per-round phase timing (one card sync per timed phase)
        self.collect_training_stats = collect_training_stats
        self.stats: Optional[TrainingMasterStats] = None

    def execute_training(self, model, data, *, epochs: int = 1):
        mesh = self.mesh or device_mesh()
        n_workers = mesh.shape["data"]
        self.stats = (TrainingMasterStats()
                      if self.collect_training_stats else None)
        trainer = ParallelTrainer(
            model, mesh, mode="averaging",
            averaging_frequency=self.averaging_frequency,
            average_updater_state=self.average_updater_state,
            stats=self.stats)
        x, y = self._split(data)
        return self._run_epochs(
            model, trainer, x, y, epochs=epochs,
            batch_size=self.batch_size_per_worker * n_workers)

    def get_training_stats(self) -> Optional[TrainingMasterStats]:
        """The per-round timeline (`export_html` / `export_json`)."""
        return self.stats


class SharedTrainingMaster(TrainingMaster):
    def __init__(self, *, batch_size_per_worker: int = 32, mesh=None,
                 threshold: Optional[float] = None,
                 collect_training_stats: bool = False,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 1, max_retries: int = 0,
                 resume: bool = True, steps_per_execution: int = 1,
                 **compression_knobs):
        self.batch_size_per_worker = batch_size_per_worker
        self.steps_per_execution = steps_per_execution
        self.mesh = mesh
        self.collect_training_stats = collect_training_stats
        self.stats: Optional[TrainingMasterStats] = None
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.max_retries = max_retries
        self.resume = resume
        if threshold is not None or compression_knobs:
            log.info(
                "SharedTrainingMaster: threshold-compression knobs %s are "
                "accepted for config compatibility but unused — the "
                "synchronous exchange replaces the compressed parameter "
                "server", {"threshold": threshold, **compression_knobs})

    def execute_training(self, model, data, *, epochs: int = 1):
        mesh = self.mesh or device_mesh()
        n_workers = mesh.shape["data"]
        self.stats = (TrainingMasterStats()
                      if self.collect_training_stats else None)
        trainer = ParallelTrainer(model, mesh, mode="sync", stats=self.stats)
        x, y = self._split(data)
        return self._run_epochs(
            model, trainer, x, y, epochs=epochs,
            batch_size=self.batch_size_per_worker * n_workers)

    def get_training_stats(self) -> Optional[TrainingMasterStats]:
        return self.stats
