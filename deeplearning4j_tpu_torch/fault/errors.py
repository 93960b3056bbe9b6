"""Fault-runtime exception types (counterpart of
`deeplearning4j_tpu/fault/errors.py`): the checkpoint error and the
drill's preemption signal. The elastic signals belong to the
multi-process runtime, which is not ported."""

from __future__ import annotations


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed integrity verification (checksum mismatch,
    truncated container, corrupt deflate stream). Raised instead of the
    raw numpy/zip traceback so callers can fall back to an earlier
    checkpoint."""


class SimulatedPreemption(BaseException):
    """Raised by the fault-injection drill at the scripted step. A
    BaseException (like KeyboardInterrupt), so an `except Exception` in
    training code cannot swallow the simulated kill, as it could not
    catch a real SIGTERM."""

    def __init__(self, step: int):
        super().__init__(f"simulated preemption at step {step}")
        self.step = step
