"""Minibatch iteration for `fit` and `evaluate` (counterpart of
`deeplearning4j_tpu/datasets/iterator.py`: `ListDataSetIterator` :62,
`ArrayDataSetIterator` :82, `AsyncDataSetIterator` :166, the wrappers
`MultipleEpochsIterator` :288, `EarlyTerminationDataSetIterator` :302,
`SamplingDataSetIterator` :320, `BenchmarkDataSetIterator` :346 and
`TimedDataSetIterator` :369, `as_iterator` :418). `DataSet` lives in
`datasets/dataset.py` and is re-exported here.

Batches come in order, the partial tail batch included, each with its
slice of the features and label masks. With `shuffle=True` every pass
permutes the example indices with one `np.random.default_rng(seed)`
stream created with the iterator (seed 123 by default), so a `fit` of
several epochs draws the same permutations as the JAX `fit`. A
`DataSet` given to `fit` is cut into batches in order, never shuffled,
as in JAX.

Checkpointable iterators keep the position contract of the JAX
`DataSetIterator` (:46-49, :131-160): `cursor()` is a json-safe dict
``{"epoch", "batch", "seed", "shuffle"}`` (the pass index, the batches
consumed in it, counted BEFORE each yield, and the shuffle stream), and
`seek(cursor)` moves a fresh iterator there: the prior passes' shuffle
draws are replayed from the seed, so the resumed pass draws JAX's
permutation and skips the consumed batches. The base returns None and
refuses `seek`.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, _cut


class DataSetIterator:
    """An iterable of `DataSet` minibatches with `reset()` and the
    position contract (`cursor()`, `seek()`)."""

    def __iter__(self):
        raise NotImplementedError

    def reset(self) -> None:
        pass

    def cursor(self) -> Optional[dict]:
        return None

    def seek(self, cursor: dict) -> None:
        raise NotImplementedError(
            f"{type(self).__name__} does not implement the "
            f"cursor()/seek() position contract")

    def batch_size(self) -> Optional[int]:
        return None

    def total_outcomes(self) -> Optional[int]:
        return None

    def input_columns(self) -> Optional[int]:
        return None


class ListDataSetIterator(DataSetIterator):
    """Iterate a list of `DataSet`s as they are."""

    def __init__(self, datasets: List[DataSet]):
        self._datasets = list(datasets)

    def __iter__(self):
        return iter(self._datasets)


class ArrayDataSetIterator(DataSetIterator):
    """Minibatches over (features, labels) arrays and their masks,
    optionally shuffled each pass."""

    def __init__(self, features, labels=None, batch_size: int = 32,
                 shuffle: bool = False, seed: int = 123,
                 features_mask=None, labels_mask=None):
        self.features = np.asarray(features)
        self.labels = None if labels is None else np.asarray(labels)
        self.features_mask = (None if features_mask is None
                              else np.asarray(features_mask))
        self.labels_mask = (None if labels_mask is None
                            else np.asarray(labels_mask))
        if int(batch_size) < 1:
            raise ValueError(f"batch_size must be >= 1; got {batch_size}")
        self._batch = int(batch_size)
        self._shuffle = shuffle
        self._seed = int(seed)
        self._rng = np.random.default_rng(seed)
        # passes started, batches consumed in this pass, batches the next
        # pass skips (a seek's)
        self._epochs_started = 0
        self._yielded = 0
        self._skip = 0

    def __iter__(self):
        n = self.features.shape[0]
        idx = np.arange(n)
        if self._shuffle:
            self._rng.shuffle(idx)
        self._epochs_started += 1
        skip, self._skip = self._skip, 0
        self._yielded = skip
        for bi, i in enumerate(range(0, n, self._batch)):
            if bi < skip:
                continue
            sel = idx[i:i + self._batch]
            # counted before the yield: a cursor() taken while the
            # consumer holds this batch includes it
            self._yielded += 1
            yield DataSet(self.features[sel], _cut(self.labels, sel),
                          _cut(self.features_mask, sel),
                          _cut(self.labels_mask, sel))

    def batch_size(self) -> int:
        return self._batch

    def total_outcomes(self):
        return None if self.labels is None else self.labels.shape[-1]

    def cursor(self) -> dict:
        return {"epoch": max(0, self._epochs_started - 1),
                "batch": int(self._yielded), "seed": self._seed,
                "shuffle": bool(self._shuffle)}

    def seek(self, cursor: dict):
        """Move to `cursor`: the shuffle stream is rebuilt from the seed
        and advanced by the prior passes' draws (a Generator's shuffle
        consumes state by length only), so the next pass draws the
        interrupted pass's permutation and skips its consumed
        batches."""
        epoch = int(cursor["epoch"])
        seed = cursor.get("seed")
        self._seed = self._seed if seed is None else int(seed)
        self._rng = np.random.default_rng(self._seed)
        if self._shuffle:
            scratch = np.arange(self.features.shape[0])
            for _ in range(epoch):
                self._rng.shuffle(scratch)
        self._epochs_started = epoch
        self._skip = int(cursor["batch"])
        self._yielded = 0


class AsyncDataSetIterator(DataSetIterator):
    """Background-thread prefetch over `base` (the JAX
    `AsyncDataSetIterator`, reference `AsyncDataSetIterator.java`): a
    worker thread fills a bounded queue of `prefetch` batches so the
    base's batch assembly overlaps the consumer's steps.

    A consumer that stops early (`break`, `close()`) does not strand the
    worker: the generator's `finally` sets the stop event, calls the
    base's `abandon()` when it has one (an unbounded stream's worker may
    be blocked inside the base's watermark wait, where the stop event is
    invisible: `online/iterator.py`), drains the queue so a pending put
    completes, and joins the thread. An exception in the base is raised
    in the consumer. The cursor counts the batches the CONSUMER has
    taken, not those prefetched."""

    _SENTINEL = object()

    def __init__(self, base: DataSetIterator, prefetch: int = 4):
        self.base = base
        self.prefetch = prefetch
        self._consumed = 0
        self._seek_offset = 0

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        err: list = []

        def put(item):
            # bounded put that gives up once the consumer has gone
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return
                except queue.Full:
                    continue

        def worker():
            try:
                for ds in self.base:
                    put(ds)
                    if stop.is_set():
                        return
            except Exception as e:  # noqa: BLE001 — raised in the consumer
                err.append(e)
            finally:
                put(self._SENTINEL)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        self._consumed, self._seek_offset = self._seek_offset, 0
        try:
            while True:
                item = q.get()
                if item is self._SENTINEL:
                    if err:
                        raise err[0]
                    return
                # counted before the yield, as the base counts
                self._consumed += 1
                yield item
        finally:
            stop.set()
            abandon = getattr(self.base, "abandon", None)
            if abandon is not None:
                abandon()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5)

    def reset(self):
        self.base.reset()

    def cursor(self):
        """The base's cursor with the batch index the consumer reached
        (prefetched batches it never took are replayed after a
        restore)."""
        cur = self.base.cursor()
        if cur is None:
            return None
        cur = dict(cur)
        cur["batch"] = int(self._consumed)
        return cur

    def seek(self, cursor: dict):
        self.base.seek(cursor)
        self._seek_offset = int(cursor.get("batch", 0))

    def batch_size(self):
        return self.base.batch_size()



class MultipleEpochsIterator(DataSetIterator):
    """Replays the base iterator `epochs` times, resetting it before
    each pass."""

    def __init__(self, epochs: int, base: DataSetIterator):
        self.epochs = epochs
        self.base = base

    def __iter__(self):
        for _ in range(self.epochs):
            self.base.reset()
            yield from self.base


class EarlyTerminationDataSetIterator(DataSetIterator):
    """The base iterator's first `max_batches` minibatches."""

    def __init__(self, base: DataSetIterator, max_batches: int):
        self.base = base
        self.max_batches = max_batches

    def __iter__(self):
        for i, ds in enumerate(self.base):
            if i >= self.max_batches:
                return
            yield ds

    def reset(self):
        self.base.reset()


class SamplingDataSetIterator(DataSetIterator):
    """`total_batches` minibatches of `batch_size` examples drawn with
    replacement from one DataSet by `np.random.default_rng(seed)`, the
    JAX iterator's draws."""

    def __init__(self, dataset: DataSet, batch_size: int,
                 total_batches: int, seed: int = 123):
        self.dataset = dataset
        self._batch = batch_size
        self.total_batches = total_batches
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        n = self.dataset.num_examples()
        for _ in range(self.total_batches):
            sel = self._rng.integers(0, n, size=self._batch)
            d = self.dataset
            yield DataSet(np.asarray(d.features)[sel], _cut(d.labels, sel),
                          _cut(d.features_mask, sel),
                          _cut(d.labels_mask, sel))

    def batch_size(self):
        return self._batch


class BenchmarkDataSetIterator(DataSetIterator):
    """One synthetic batch (standard-normal features, one-hot labels or
    standard-normal labels of `label_shape`) yielded `total_batches`
    times, to time compute without ETL; the JAX iterator's numbers for
    the same seed."""

    def __init__(self, feature_shape, num_classes: int, total_batches: int,
                 seed: int = 42, label_shape=None):
        rng = np.random.default_rng(seed)
        self.features = rng.standard_normal(feature_shape).astype(
            np.float32)
        batch = feature_shape[0]
        if label_shape is not None:
            self.labels = rng.standard_normal(label_shape).astype(
                np.float32)
        else:
            idx = rng.integers(0, num_classes, size=batch)
            self.labels = np.eye(num_classes, dtype=np.float32)[idx]
        self.total_batches = total_batches

    def __iter__(self):
        for _ in range(self.total_batches):
            yield DataSet(self.features, self.labels)

    def batch_size(self):
        return self.features.shape[0]


class TimedDataSetIterator(DataSetIterator):
    """Times each batch's assembly in the base iterator (`last_etl_ms`,
    `total_etl_ms`, `batches`); the position contract and the widths
    pass through."""

    def __init__(self, base: DataSetIterator):
        self.base = base
        self.last_etl_ms = 0.0
        self.total_etl_ms = 0.0
        self.batches = 0

    def __iter__(self):
        it = iter(self.base)
        while True:
            t0 = time.perf_counter()
            try:
                ds = next(it)
            except StopIteration:
                return
            self.last_etl_ms = (time.perf_counter() - t0) * 1e3
            self.total_etl_ms += self.last_etl_ms
            self.batches += 1
            yield ds

    def reset(self):
        self.base.reset()

    def cursor(self):
        return self.base.cursor()

    def seek(self, cursor):
        self.base.seek(cursor)

    def batch_size(self):
        return self.base.batch_size()

    def total_outcomes(self):
        return self.base.total_outcomes()

    def input_columns(self):
        return self.base.input_columns()

def as_iterator(data, labels=None, batch_size: int = 32, **kw):
    """Coerce `fit()`-style inputs into an iterable of `DataSet`s: an
    iterator passes as it is, a `DataSet` is cut into batches in order
    (its masks too), a list of `DataSet`s is taken as the batches, and
    arrays go through `ArrayDataSetIterator`."""
    if isinstance(data, DataSetIterator):
        return data
    if isinstance(data, DataSet):
        return ListDataSetIterator(data.batch_by(batch_size))
    if (isinstance(data, (list, tuple)) and data
            and isinstance(data[0], DataSet)):
        return ListDataSetIterator(data)
    return ArrayDataSetIterator(data, labels, batch_size=batch_size, **kw)
