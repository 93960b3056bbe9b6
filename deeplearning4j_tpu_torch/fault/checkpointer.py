"""Async, atomic full-state checkpointer (counterpart of
`deeplearning4j_tpu/fault/checkpointer.py`, single-process).

Write protocol (a preemption cannot tear a checkpoint):

1. `save(state, step)`: the device-to-host snapshot already happened in
   `capture_training_state` (on the training thread, at a step
   boundary, before the next step writes the tensors in place); save()
   only enqueues the host trees and returns. Training never waits on
   the filesystem.
2. one background writer thread serializes the snapshot into
   ``<dir>/.tmp-ckpt-<step>/``: ``shard-00000.npz`` with every array
   (flat ``\\x1f``-path keys), ``manifest-00000.json`` with a crc32 per
   array, then the merged ``MANIFEST.json``. Every file is flushed and
   fsync'd, the tmp dir fsync'd, then renamed to ``ckpt-<step>`` and the
   parent dir fsync'd. A kill at any instant leaves a committed
   checkpoint or an ignored ``.tmp-*`` orphan (collected at the next
   commit), never a half-readable one.
3. retention: the newest `keep_last` checkpoints stay, and every one
   whose step is a multiple of `keep_every`; the rest go after the
   commit.

The layout is the JAX package's, so each package resumes what the
other wrote. A snapshot that arrives while the writer is busy replaces
the pending one (latest wins: the backlog never grows). A writer error
is raised again on the training thread at the next `save()` or
`wait()`. The multi-process barrier manifests and the registry gauges
are not ported (ROADMAP Queue 1 item 7 and item 5).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.fault import state as fstate
from deeplearning4j_tpu_torch.fault.errors import CheckpointCorruptError

log = logging.getLogger("deeplearning4j_tpu_torch.fault")

MANIFEST_NAME = "MANIFEST.json"
_CKPT_PREFIX = "ckpt-"
_TMP_PREFIX = ".tmp-"


def _fsync_dir(path: Path):
    try:
        fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _ckpt_dirname(step: int) -> str:
    return f"{_CKPT_PREFIX}{step:08d}"


def list_checkpoints(directory) -> List[int]:
    """Committed checkpoint steps (ascending). Only directories with a
    merged MANIFEST.json count — a torn tmp dir is invisible here."""
    directory = Path(directory)
    steps = []
    if not directory.is_dir():
        return steps
    for entry in directory.iterdir():
        if (entry.name.startswith(_CKPT_PREFIX) and entry.is_dir()
                and (entry / MANIFEST_NAME).is_file()):
            try:
                steps.append(int(entry.name[len(_CKPT_PREFIX):]))
            except ValueError:
                continue
    return sorted(steps)


def load_checkpoint(directory, step: int) -> Dict[str, Any]:
    """Read + integrity-verify one committed checkpoint. Returns the
    `capture_training_state` structure. Raises `CheckpointCorruptError`
    on any checksum/container damage."""
    cdir = Path(directory) / _ckpt_dirname(step)
    mpath = cdir / MANIFEST_NAME
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(
            f"{mpath}: unreadable manifest ({e})") from e
    flat: Dict[str, np.ndarray] = {}
    for shard in manifest.get("shards", []):
        spath = cdir / shard
        try:
            with np.load(spath, allow_pickle=False) as data:
                for k in data.files:
                    flat[k] = data[k]
        except Exception as e:  # truncated/garbled npz → typed error
            raise CheckpointCorruptError(
                f"{spath}: unreadable shard ({e})") from e
    fstate.verify_checksums(flat, {k: int(v) for k, v in
                                   manifest.get("checksums", {}).items()},
                            context=str(cdir))
    return {"arrays": fstate.unflatten_arrays(flat),
            "meta": manifest["meta"]}


class AsyncCheckpointer:
    def __init__(self, directory, *, keep_last: int = 3,
                 keep_every: Optional[int] = None, async_write: bool = True):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        if keep_last < 1:
            raise ValueError(f"keep_last must be >= 1, got {keep_last}")
        if keep_every is not None and keep_every < 1:
            raise ValueError(f"keep_every must be >= 1, got {keep_every}")
        self.keep_last = keep_last
        self.keep_every = keep_every
        self.async_write = async_write
        self._lock = threading.Lock()
        self._pending: Optional[tuple] = None      # (step, state) latest-wins
        self._wake = threading.Condition(self._lock)
        self._busy = False
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        self._last_error: Optional[BaseException] = None
        self._last_commit_ts: Optional[float] = None
        # (seconds, bytes) of the last committed write
        self.last_write: Optional[tuple] = None

    # ------------------------------------------------------------- public
    def save(self, state: Dict[str, Any], step: int, *,
             blocking: bool = False) -> int:
        """Enqueue one snapshot for durable write (or write inline when
        `blocking` or the checkpointer was built with
        async_write=False). Re-raises the writer thread's last error so
        persistent disk failures surface on the training thread instead
        of looping silently."""
        self._raise_pending_error()
        if self._closed:
            raise RuntimeError("checkpointer is closed")
        if blocking or not self.async_write:
            self._write(step, state)
            return step
        with self._lock:
            if self._pending is not None:
                log.warning(
                    "checkpoint writer busy: dropping queued snapshot for "
                    "step %d in favor of step %d", self._pending[0], step)
            self._pending = (step, state)
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._worker, name="dl4j-torch-checkpoint-writer",
                    daemon=True)
                self._thread.start()
            self._wake.notify_all()
        return step

    def wait(self):
        """Block until every enqueued snapshot is committed (end of
        fit / tests / drills), then surface any writer error."""
        with self._lock:
            while self._pending is not None or self._busy:
                self._wake.wait(timeout=0.1)
        self._raise_pending_error()

    def close(self):
        self.wait()
        with self._lock:
            self._closed = True
            self._wake.notify_all()

    def steps(self) -> List[int]:
        return list_checkpoints(self.directory)

    def load(self, step: Optional[int] = None) -> Dict[str, Any]:
        """Load a committed checkpoint (latest when step is None)."""
        steps = self.steps()
        if not steps:
            raise FileNotFoundError(
                f"no committed checkpoints under {self.directory}")
        return load_checkpoint(self.directory,
                               steps[-1] if step is None else step)

    # ------------------------------------------------------------- worker
    def _raise_pending_error(self):
        err, self._last_error = self._last_error, None
        if err is not None:
            raise err

    def _worker(self):
        while True:
            with self._lock:
                while self._pending is None and not self._closed:
                    self._wake.wait(timeout=0.5)
                if self._pending is None and self._closed:
                    return
                step, state = self._pending
                self._pending = None
                self._busy = True
            try:
                self._write(step, state)
            except BaseException as e:  # surfaced on next save()/wait()
                log.warning("async checkpoint write for step %d failed: %s",
                            step, e)
                self._last_error = e
            finally:
                with self._lock:
                    self._busy = False
                    self._wake.notify_all()

    # -------------------------------------------------------------- write
    def _write(self, step: int, state: Dict[str, Any]):
        t0 = time.perf_counter()
        tmp = self.directory / f"{_TMP_PREFIX}{_ckpt_dirname(step)}"
        final = self.directory / _ckpt_dirname(step)
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        flat = fstate.flatten_arrays(state["arrays"])
        checksums = fstate.checksum_flat(flat)
        shard_name = "shard-00000.npz"
        spath = tmp / shard_name
        with open(spath, "wb") as f:
            np.savez(f, **flat)
            f.flush()
            os.fsync(f.fileno())
        nbytes = spath.stat().st_size
        pmanifest = {"process": 0, "shard": shard_name,
                     "checksums": checksums, "meta": state["meta"]}
        _write_json(tmp / "manifest-00000.json", pmanifest)
        _write_json(tmp / MANIFEST_NAME, {
            "format_version": fstate.STATE_FORMAT_VERSION,
            "step": step, "process_count": 1, "shards": [shard_name],
            "checksums": checksums, "meta": state["meta"]})
        _fsync_dir(tmp)
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        _fsync_dir(self.directory)
        self._gc()
        self._last_commit_ts = time.time()
        self.last_write = (time.perf_counter() - t0, nbytes)

    # ----------------------------------------------------------- retention
    def _retained(self, steps: List[int]) -> set:
        keep = set(steps[-self.keep_last:])
        if self.keep_every:
            keep.update(s for s in steps if s % self.keep_every == 0)
        return keep

    def _gc(self):
        steps = list_checkpoints(self.directory)
        keep = self._retained(steps)
        for s in steps:
            if s not in keep:
                shutil.rmtree(self.directory / _ckpt_dirname(s),
                              ignore_errors=True)
        # orphaned tmp dirs of a crashed writer, at or below the newest
        # committed step
        newest = steps[-1] if steps else -1
        for entry in self.directory.glob(f"{_TMP_PREFIX}{_CKPT_PREFIX}*"):
            try:
                tstep = int(entry.name[len(_TMP_PREFIX) + len(_CKPT_PREFIX):])
            except ValueError:
                continue
            if tstep <= newest:
                shutil.rmtree(entry, ignore_errors=True)


def _write_json(path: Path, obj):
    with open(path, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
