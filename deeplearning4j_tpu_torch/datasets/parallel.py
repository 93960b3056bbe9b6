"""Parallel data iterators and the host-to-card copy overlap
(counterpart of `deeplearning4j_tpu/datasets/parallel.py`).

The producers (reference `datasets/iterator/parallel/`):
`BaseParallelDataSetIterator` takes batches round-robin from N
producers, each behind its own `AsyncDataSetIterator` buffer, with an
`InequalityHandling` for producers that run out unevenly;
`JointParallelDataSetIterator` is N independent iterators;
`FileSplitParallelDataSetIterator` deals the files under a root that
match a pattern across N producers and makes each file a DataSet with a
callback.

`DevicePrefetchIterator` keeps the next batches' host-to-card copies in
flight while the card computes on the current one, the PyTorch way:
each batch is staged in pinned host memory and copied with
`non_blocking=True` on a side stream, an event recorded after the
copies is what the consuming stream waits on before it uses the batch,
and each copied tensor is `record_stream`-ed on the consuming stream so
the caching allocator does not hand its memory to another tensor while
work that reads it is still queued. `fit` binds the iterator to the net
(`bind_model`), so the net's own host conversion (`host_batch`: token
ids checked against the vocabulary and made int64, features and labels
in their dtypes) runs on the host BEFORE the copy: an id out of range
is refused there, never indexed on the card. Each copy is counted on
`jax_transfers_total{direction="h2d"}` while monitoring is on.
"""

from __future__ import annotations

import fnmatch
import os
from collections import deque
from enum import Enum
from typing import Callable, List, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import (
    AsyncDataSetIterator,
    DataSetIterator,
)


class InequalityHandling(str, Enum):
    """What to do when producers deplete unevenly (reference
    `nd4j ...iterator.enums.InequalityHandling`)."""

    STOP_EVERYONE = "stop_everyone"   # first depleted producer ends it all
    RELOCATE = "relocate"             # skip depleted, drain the rest
    RESET = "reset"                   # restart depleted until all have wrapped
    PASS_NULL = "pass_null"           # yield None for depleted producers


class BaseParallelDataSetIterator(DataSetIterator):
    """Round-robin over N producers with inequality handling
    (reference `BaseParallelDataSetIterator.java` hasNext switch)."""

    def __init__(self, producers: Sequence[DataSetIterator],
                 inequality_handling: InequalityHandling =
                 InequalityHandling.STOP_EVERYONE,
                 prefetch: int = 2):
        if not producers:
            raise ValueError("need at least one producer iterator")
        self.producers = list(producers)
        self.inequality_handling = InequalityHandling(inequality_handling)
        self.prefetch = prefetch

    def _wrapped(self) -> List[DataSetIterator]:
        if self.prefetch > 0:
            return [AsyncDataSetIterator(p, prefetch=self.prefetch)
                    for p in self.producers]
        return list(self.producers)

    def __iter__(self):
        mode = self.inequality_handling
        its = [iter(p) for p in self._wrapped()]
        n = len(its)
        active = [True] * n
        wrapped_once = [False] * n   # RESET: stop after every producer wrapped

        def pull(i):
            try:
                return next(its[i]), True
            except StopIteration:
                return None, False

        i = 0
        while any(active):
            if active[i]:
                ds, ok = pull(i)
                if ok:
                    yield ds
                    i = (i + 1) % n
                    continue
                # producer i just depleted
                if mode == InequalityHandling.STOP_EVERYONE:
                    return
                if mode == InequalityHandling.RESET:
                    wrapped_once[i] = True
                    if all(wrapped_once):
                        return
                    self.producers[i].reset()
                    its[i] = iter(AsyncDataSetIterator(
                        self.producers[i], prefetch=self.prefetch)
                        if self.prefetch > 0 else self.producers[i])
                    ds, ok = pull(i)       # retry the producer ONCE
                    if ok:
                        yield ds
                        i = (i + 1) % n
                    else:
                        # empty even after reset: drop it or a zero-batch
                        # producer would busy-loop forever
                        active[i] = False
                        i = (i + 1) % n
                    continue
                active[i] = False          # RELOCATE / PASS_NULL
                if mode == InequalityHandling.PASS_NULL:
                    if not any(active):
                        return
                    yield None
                    i = (i + 1) % n
                    continue
            else:
                if mode == InequalityHandling.PASS_NULL:
                    yield None
                i = (i + 1) % n

    def reset(self):
        for p in self.producers:
            p.reset()


class JointParallelDataSetIterator(BaseParallelDataSetIterator):
    """N independent source iterators interleaved round-robin, each with
    its own async prefetch buffer (reference
    `JointParallelDataSetIterator.java`)."""


class FileSplitParallelDataSetIterator(BaseParallelDataSetIterator):
    """Files under `root` matching `pattern`, dealt round-robin across
    `num_producers` file lists; `callback(path) -> DataSet` loads one
    file per batch (reference `FileSplitParallelDataSetIterator.java`
    with its `FileCallback`)."""

    def __init__(self, root: str, pattern: str,
                 callback: Callable[[str], DataSet],
                 num_producers: int = 2,
                 inequality_handling: InequalityHandling =
                 InequalityHandling.STOP_EVERYONE,
                 prefetch: int = 2):
        paths: List[str] = []
        for dirpath, _, files in sorted(os.walk(root)):
            for f in sorted(files):
                if fnmatch.fnmatch(f, pattern):
                    paths.append(os.path.join(dirpath, f))
        if not paths:
            raise ValueError(f"no files under {root} match {pattern!r}")
        self.paths = paths
        num_producers = max(1, min(num_producers, len(paths)))
        splits = [paths[i::num_producers] for i in range(num_producers)]
        producers = [_FileListIterator(split, callback) for split in splits]
        super().__init__(producers, inequality_handling, prefetch)


class _FileListIterator(DataSetIterator):
    def __init__(self, paths: List[str], callback: Callable[[str], DataSet]):
        self.paths = paths
        self.callback = callback

    def __iter__(self):
        for p in self.paths:
            yield self.callback(p)

    def reset(self):
        pass


class DevicePrefetchIterator(DataSetIterator):
    """Keeps `depth` batches of `base` in flight to `device` (see the
    module docstring for the staging). On a CPU device the batches are
    converted and handed over with no copy. `sharding=` (a
    `parallel.placement.DataSharding`, or a mesh for its "data" axis)
    lands each replica's row block of features and labels on that
    replica's device (`ReplicaBatch`), as a data-parallel trainer takes
    them."""

    def __init__(self, base: DataSetIterator, depth: int = 2,
                 sharding=None, device="cuda"):
        from deeplearning4j_tpu_torch.device import resolve_device
        if sharding is not None:
            from deeplearning4j_tpu_torch.parallel.placement import (
                DataSharding)
            if not isinstance(sharding, DataSharding):
                sharding = DataSharding(sharding)
            device = sharding.devices[0]
        self.sharding = sharding
        self.base = base
        self.depth = max(1, depth)
        self.device = resolve_device(device)
        self._prepare = None
        self._stream = None

    def bind_model(self, model):
        """Stage batches as `model` converts them (`model.host_batch`), on
        the model's device (the replicas' devices when sharded); `fit`
        calls this."""
        self._prepare = model.host_batch
        if self.sharding is None:
            self.device = model.device

    def _host(self, ds: DataSet) -> DataSet:
        if self._prepare is not None:
            return self._prepare(ds)

        def t(a):
            return None if a is None else torch.as_tensor(np.asarray(a))
        return DataSet(t(ds.features), t(ds.labels), t(ds.features_mask),
                       t(ds.labels_mask), ds.example_metadata)

    def _put(self, ds: DataSet):
        """Start the batch's copies; returns (card DataSet, event, card
        tensors), or (host DataSet, None, []) on a CPU device."""
        host = self._host(ds)
        if self.sharding is not None:
            from deeplearning4j_tpu_torch.parallel.placement import (
                shard_rows)
            return (DataSet(shard_rows(host.features, self.sharding),
                            None if host.labels is None
                            else shard_rows(host.labels, self.sharding),
                            None, None, host.example_metadata), None, [])
        if self.device.type != "cuda":
            return host, None, []
        from deeplearning4j_tpu_torch import monitor
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        out = []
        with torch.cuda.stream(self._stream):
            for a in (host.features, host.labels, host.features_mask,
                      host.labels_mask):
                if a is None:
                    out.append(None)
                    continue
                out.append(a.pin_memory().to(self.device, non_blocking=True))
                monitor.record_transfer(a.numel() * a.element_size(), "h2d")
            event = torch.cuda.Event()
            event.record(self._stream)
        return (DataSet(*out, host.example_metadata), event,
                [t for t in out if t is not None])

    def _hand(self, item) -> DataSet:
        ds, event, tensors = item
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            for t in tensors:
                t.record_stream(consumer)
        return ds

    def __iter__(self):
        buf: deque = deque()
        for ds in self.base:
            buf.append(self._put(ds))
            if len(buf) >= self.depth:
                yield self._hand(buf.popleft())
        while buf:
            yield self._hand(buf.popleft())

    def reset(self):
        self.base.reset()

    def batch_size(self):
        return self.base.batch_size()
