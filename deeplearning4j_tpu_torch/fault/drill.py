"""Fault-injection drills (counterpart of
`deeplearning4j_tpu/fault/drill.py`): prove on schedule that a run
killed at step k resumes bit for bit and that a corrupted newest
checkpoint falls back to the one before.

- `PreemptionListener`: a scripted preemption at step k from the
  listener bus: mode "exception" raises `SimulatedPreemption` (a
  BaseException), "sigterm" delivers a real SIGTERM to the process and
  "sigkill" a SIGKILL (for drills that run the fit in a subprocess).
- `corrupt_checkpoint`: flip a byte of, or truncate, a committed shard
  or its manifest.
- `auto_resume`: run `attempt_fn` again after each `SimulatedPreemption`
  until it completes.
"""

from __future__ import annotations

import json
import logging
import os
import signal
from pathlib import Path
from typing import Callable, Optional

from deeplearning4j_tpu_torch.fault.checkpointer import (
    MANIFEST_NAME,
    _ckpt_dirname,
    list_checkpoints,
)
from deeplearning4j_tpu_torch.fault.errors import SimulatedPreemption
from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener

log = logging.getLogger("deeplearning4j_tpu_torch.fault")


class PreemptionListener(TrainingListener):
    """Kill the training run at the first step boundary >= `kill_at_step`
    completed steps (exact at `kill_at_step` when the fit runs
    per-step; fused groups die at their boundary, like a real SIGTERM
    landing between dispatches)."""

    def __init__(self, kill_at_step: int, *, mode: str = "exception",
                 wait_for_checkpointer=None):
        if mode not in ("exception", "sigterm", "sigkill"):
            raise ValueError(
                f"mode must be exception|sigterm|sigkill, got {mode}")
        self.kill_at_step = int(kill_at_step)
        self.mode = mode
        # optional: drain this AsyncCheckpointer before dying — drills
        # the "preemption notice" path (SIGTERM + grace period) as
        # opposed to the default hard-kill path
        self.wait_for_checkpointer = wait_for_checkpointer
        self.fired = False

    def iteration_done(self, model, iteration, epoch, score, **info):
        if self.fired or not info.get("step_boundary", True):
            return
        if iteration + 1 < self.kill_at_step:
            return
        self.fired = True
        if self.wait_for_checkpointer is not None:
            self.wait_for_checkpointer.wait()
        log.warning("injecting preemption at step %d (%s)", iteration + 1,
                    self.mode)
        if self.mode == "sigterm":
            os.kill(os.getpid(), signal.SIGTERM)
        elif self.mode == "sigkill":
            # an instant death the process cannot observe: no drain, no
            # final checkpoint
            os.kill(os.getpid(), signal.SIGKILL)
        raise SimulatedPreemption(iteration + 1)


def corrupt_checkpoint(directory, *, step: Optional[int] = None,
                       mode: str = "flip", target: str = "shard") -> Path:
    """Damage a committed checkpoint in place (newest when step=None).

    mode="flip" xors one byte mid-file (silent bit rot — caught only by
    checksums); mode="truncate" halves the file (torn write past the
    atomic-rename protocol, e.g. disk-level damage). target="shard"
    hits the array payload, target="manifest" the merged manifest.
    Returns the damaged path."""
    steps = list_checkpoints(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    step = steps[-1] if step is None else step
    cdir = Path(directory) / _ckpt_dirname(step)
    if target == "manifest":
        path = cdir / MANIFEST_NAME
    else:
        shards = sorted(cdir.glob("shard-*.npz"))
        if not shards:
            raise FileNotFoundError(f"no shards in {cdir}")
        path = shards[0]
    size = path.stat().st_size
    if mode == "truncate":
        with open(path, "r+b") as f:
            f.truncate(max(1, size // 2))
    elif mode == "flip":
        with open(path, "r+b") as f:
            f.seek(size // 2)
            b = f.read(1)
            f.seek(size // 2)
            f.write(bytes([b[0] ^ 0xFF]))
    else:
        raise ValueError(f"mode must be flip|truncate, got {mode}")
    log.warning("injected %s corruption into %s", mode, path)
    return path


def auto_resume(attempt_fn: Callable[[int], object], *,
                max_restarts: int = 5):
    """In-process restart loop: call `attempt_fn(attempt)` until it
    returns (instead of dying to `SimulatedPreemption`). `attempt_fn`
    sees attempt=0 for the cold start and is expected to resume from
    the checkpoint directory on attempt >= 1. Returns
    (result, restarts)."""
    for attempt in range(max_restarts + 1):
        try:
            return attempt_fn(attempt), attempt
        except SimulatedPreemption as e:
            log.warning("attempt %d preempted at step %d; restarting",
                        attempt, e.step)
    raise RuntimeError(
        f"training did not complete within {max_restarts} restarts")


def checkpoint_meta(directory, step: Optional[int] = None) -> dict:
    """The merged manifest's meta block (no array IO — drill/tooling
    introspection)."""
    steps = list_checkpoints(directory)
    step = steps[-1] if step is None else step
    with open(Path(directory) / _ckpt_dirname(step) / MANIFEST_NAME) as f:
        return json.load(f)["meta"]
