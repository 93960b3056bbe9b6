"""CheckpointListener: the fit loop's wiring of the fault runtime
(counterpart of `deeplearning4j_tpu/fault/listener.py`). Attach it with
`model.add_listener(...)`; both containers' `fit` feed it.

Under `steps_per_execution > 1` the fit runs a group's steps, then
makes one callback per step: the earlier callbacks see the group's
final params with an earlier iteration, a pair that must never be
checkpointed (a resume would apply steps twice). Only the group's last
callback carries ``step_boundary=True``; this listener captures there,
and its cadence is "`frequency` steps since the last save" rather than
a modulo, so a boundary off the cadence checkpoints at the next legal
one.
"""

from __future__ import annotations

from typing import Optional

from deeplearning4j_tpu_torch.fault.checkpointer import AsyncCheckpointer
from deeplearning4j_tpu_torch.fault.state import capture_training_state
from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener


class CheckpointListener(TrainingListener):
    def __init__(self, checkpointer, *, frequency: int = 10,
                 epoch_frequency: Optional[int] = None,
                 iterator=None, normalizer=None,
                 save_at_fit_end: bool = False):
        """`checkpointer`: an AsyncCheckpointer or a directory path.
        `frequency`: checkpoint every N completed steps (at the nearest
        step boundary); `epoch_frequency`: additionally at every Nth
        epoch end; `iterator`: the training DataSetIterator whose
        `cursor()` should ride along (pass the SAME object given to
        fit); `normalizer`: fitted DataNormalization to persist."""
        if not isinstance(checkpointer, AsyncCheckpointer):
            checkpointer = AsyncCheckpointer(checkpointer)
        self.checkpointer = checkpointer
        self.frequency = max(1, int(frequency))
        self.epoch_frequency = epoch_frequency
        self.iterator = iterator
        self.normalizer = normalizer
        self.save_at_fit_end = save_at_fit_end
        self._last_saved_step = 0

    # ------------------------------------------------------------ capture
    def _save(self, model, step: int, epoch: int, *,
              epoch_complete: bool = False):
        state = capture_training_state(
            model, iterator=self.iterator, normalizer=self.normalizer,
            step=step, epoch=epoch)
        if epoch_complete and state["meta"].get("iterator") is not None:
            # epoch-end save: epoch_count records the completed epoch,
            # so the cursor must point at the NEXT pass's start — kept
            # as {epoch: e, batch: <full>} it would pair with the
            # incremented epoch_count and double-count the completed
            # epoch (resume would train one epoch short)
            cur = state["meta"]["iterator"]
            state["meta"]["iterator"] = {**cur, "epoch": epoch, "batch": 0}
        self.checkpointer.save(state, step)
        self._last_saved_step = step

    def save_now(self, model, step: int, epoch: int):
        """An out-of-cadence checkpoint at a step boundary the caller
        chose; the cadence counts on from here."""
        self._save(model, int(step), int(epoch))

    def iteration_done(self, model, iteration, epoch, score, **info):
        if not info.get("step_boundary", True):
            return
        step = iteration + 1          # completed steps
        if step - self._last_saved_step < self.frequency:
            return
        self._save(model, step, epoch)

    def on_epoch_end(self, model, epoch):
        if (self.epoch_frequency
                and (epoch + 1) % self.epoch_frequency == 0):
            self._save(model, int(model.iteration_count), epoch + 1,
                       epoch_complete=True)

    def on_fit_end(self, model):
        if self.save_at_fit_end and \
                int(model.iteration_count) > self._last_saved_step:
            self._save(model, int(model.iteration_count),
                       int(model.epoch_count))
        # a checkpoint enqueued on the last step must be durable before
        # the process exits fit() believing it is protected
        self.checkpointer.wait()
