"""`resume(dir)`: the exact restart, with fallback past corrupt
checkpoints (counterpart of `deeplearning4j_tpu/fault/resume.py`).

Committed checkpoints are tried newest first; the first that verifies
wins, and each corrupt newer one is skipped with a logged warning. The
model is built from the stored configuration under the recorded dtype
policy when none is passed, on `device`, and the iterator moves to the
stored cursor.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional, Tuple

from deeplearning4j_tpu_torch.fault import state as fstate
from deeplearning4j_tpu_torch.fault.checkpointer import (
    list_checkpoints,
    load_checkpoint,
)
from deeplearning4j_tpu_torch.fault.errors import CheckpointCorruptError

log = logging.getLogger("deeplearning4j_tpu_torch.fault")


def load_latest_valid(directory, *, max_step: Optional[int] = None
                      ) -> Tuple[Dict[str, Any], int]:
    """(state, step) of the newest checkpoint that verifies; corrupt
    ones are skipped with a warning. Raises FileNotFoundError when the
    directory has no committed checkpoints at all, and
    CheckpointCorruptError when every committed checkpoint is damaged."""
    steps = list_checkpoints(directory)
    if max_step is not None:
        steps = [s for s in steps if s <= max_step]
    if not steps:
        raise FileNotFoundError(
            f"no committed checkpoints under {directory}")
    tried = []
    for step in reversed(steps):
        try:
            return load_checkpoint(directory, step), step
        except CheckpointCorruptError as e:
            log.warning(
                "checkpoint step %d under %s is corrupt (%s); falling "
                "back to the previous checkpoint", step, directory, e)
            tried.append((step, e))
    # name every candidate tried: there is no recovery path left, and
    # the operator needs the whole damage report
    detail = "; ".join(f"step {s}: {e}" for s, e in tried)
    raise CheckpointCorruptError(
        f"every committed checkpoint under {directory} failed "
        f"verification ({len(tried)} candidates tried) — {detail}")


def resume(directory, model=None, *, iterator=None,
           max_step: Optional[int] = None, device="cuda"):
    """Restore the newest valid checkpoint; returns ``(model, meta)``.
    `model=None` builds the container from the stored configuration on
    `device`; `iterator` is moved to the stored cursor, so no consumed
    batch replays."""
    state, step = load_latest_valid(directory, max_step=max_step)
    meta = state["meta"]
    if model is None:
        model = fstate.build_model(meta, device=device)
    fstate.restore_training_state(model, state, iterator=iterator)
    log.info("resumed training state from step %d under %s", step,
             directory)
    return model, meta
