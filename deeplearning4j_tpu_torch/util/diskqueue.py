"""Disk-backed FIFO queue (counterpart of
`deeplearning4j_tpu/util/diskqueue.py`; host code, no device).

Reference: `deeplearning4j-nn/.../util/DiskBasedQueue.java` — a Queue
whose elements spill to one-file-per-item storage so unbounded ETL
buffers don't hold the heap. Same role here (host-side ETL buffering
for iterators that produce faster than the device consumes), with a
configurable in-memory window before spilling, pickle serialization,
and context-manager cleanup. Thread-safe.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import threading
import uuid
from collections import deque
from typing import Any, Iterable, Optional


class DiskBasedQueue:
    def __init__(self, directory: Optional[str] = None,
                 memory_window: int = 0):
        """`memory_window`: items kept purely in RAM before spilling to
        disk (0 = every item goes to disk, the reference behavior)."""
        self._own_dir = directory is None
        self.dir = directory or tempfile.mkdtemp(prefix="dl4tpu-queue-")
        os.makedirs(self.dir, exist_ok=True)
        if not os.path.isdir(self.dir):
            raise ValueError(f"queue path {self.dir!r} must be a directory")
        self.memory_window = max(0, memory_window)
        self._mem: deque = deque()
        self._paths: deque = deque()
        self._lock = threading.Lock()

    # ---------------------------------------------------------- queue API
    def add(self, item: Any) -> bool:
        with self._lock:
            if len(self._mem) < self.memory_window and not self._paths:
                self._mem.append(item)
                return True
            path = os.path.join(self.dir, uuid.uuid4().hex)
            with open(path, "wb") as f:
                pickle.dump(item, f, protocol=pickle.HIGHEST_PROTOCOL)
            self._paths.append(path)
            return True

    def offer(self, item: Any) -> bool:
        return self.add(item)

    def add_all(self, items: Iterable[Any]):
        for it in items:
            self.add(it)

    def _pop_locked(self):
        if self._mem:
            return self._mem.popleft()
        path = self._paths.popleft()          # IndexError when empty
        try:
            with open(path, "rb") as f:
                return pickle.load(f)
        finally:
            os.unlink(path)

    def poll(self) -> Optional[Any]:
        """Dequeue or None when empty (reference Queue.poll)."""
        with self._lock:
            try:
                return self._pop_locked()
            except IndexError:
                return None

    def remove(self) -> Any:
        """Dequeue or raise (reference Queue.remove)."""
        with self._lock:
            try:
                return self._pop_locked()
            except IndexError:
                raise IndexError("queue is empty") from None

    def peek(self) -> Optional[Any]:
        with self._lock:
            if self._mem:
                return self._mem[0]
            if not self._paths:
                return None
            with open(self._paths[0], "rb") as f:
                return pickle.load(f)

    def size(self) -> int:
        with self._lock:
            return len(self._mem) + len(self._paths)

    def is_empty(self) -> bool:
        return self.size() == 0

    def clear(self):
        with self._lock:
            self._mem.clear()
            while self._paths:
                try:
                    os.unlink(self._paths.popleft())
                except OSError:
                    pass

    # ------------------------------------------------------------ plumbing
    def __len__(self):
        return self.size()

    def __iter__(self):
        # drain via remove() so a legitimately stored None payload is
        # yielded, not mistaken for queue-empty
        while True:
            try:
                item = self.remove()
            except IndexError:
                return
            yield item

    def close(self):
        self.clear()
        if self._own_dir:
            shutil.rmtree(self.dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
