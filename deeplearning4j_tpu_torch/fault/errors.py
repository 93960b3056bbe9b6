"""Fault-runtime exception types (counterpart of
`deeplearning4j_tpu/fault/errors.py:8`). Only the checkpoint error is
ported; the elastic and drill signals belong to the fault slice."""

from __future__ import annotations


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed integrity verification (checksum mismatch,
    truncated container, corrupt deflate stream). Raised instead of the
    raw numpy/zip traceback so callers can fall back to an earlier
    checkpoint."""
