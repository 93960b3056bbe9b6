"""StreamingDataSetIterator: the unbounded-iterator contract (counterpart
of `deeplearning4j_tpu/online/iterator.py`: `lm_example` :62,
`StreamingDataSetIterator` :77).

Every fit loop consumes a `DataSetIterator`; this adapter turns a
`streaming/` transport topic (`LocalQueueTransport`, `LocalLogTransport`,
Kafka) into one whose pass never ends on an empty queue: it blocks for
the producer, up to a watermark timeout, so `MultiLayerNetwork.fit(stream,
epochs=1)` becomes a long-lived training service fed by an input
pipeline. Host numpy, as in JAX.

Contracts:

- **Fixed-shape batches, ragged-tail hold-back.** Records are decoded
  (`record_to_example`), accumulated, and dispatched only in full
  `batch_size` groups of one shape; a partial tail is held back until
  the stream completes it (never emitted, never dropped: held-back
  records are not consumed and replay after a resume).
- **cursor() is the transport offset**: ``{"batch": batches consumed,
  "offset": records consumed, "batch_size": B}``, counted BEFORE the
  yield (a cursor taken while the consumer holds a batch includes it).
  `seek(cursor)` replays from the offset: over an offset-addressable
  transport (`LocalLogTransport.read`, Kafka) the next read starts at
  ``batch * batch_size``; over a destructive queue that many records are
  skipped, which reproduces the stream when the producer replays from
  the start.
- **Watermark semantics.** ``watermark_timeout_s`` bounds how long a pass
  waits for the next record before the stream counts as quiesced and the
  pass ends (None: wait forever); the wait polls in ``poll_s`` slices so
  `stop()` (end at the next batch boundary) and `abandon()` (a consumer
  that broke out: `AsyncDataSetIterator`'s teardown) act promptly.
- **Telemetry**: `streaming_records_consumed_total`,
  `streaming_batches_total`, and the lazy gauges
  `streaming_watermark_age_seconds` (seconds since the last record) and
  `streaming_lag_records` (producer offset minus consumed offset, when
  the transport has `producer_offset`), JAX's names.
"""


from __future__ import annotations

import queue as _queue
import threading
import time
from typing import Callable, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import DataSetIterator
from deeplearning4j_tpu_torch.streaming.ndarray import deserialize_ndarray


def _default_example(record: np.ndarray) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    return record, None


def lm_example(record: np.ndarray, *, vocab_size: int):
    """Record convention for the language-model firehose: a ``[2, T]``
    int array — row 0 the input token ids, row 1 the target ids —
    decoded into the `(x float ids [T], y one-hot [T, V])` pair the
    TransformerLM fit contract consumes."""
    ids = np.asarray(record[0], np.int64)
    tgt = np.asarray(record[1], np.int64)
    x = ids.astype(np.float32)
    # scatter, not np.eye(V)[tgt]: the identity-matrix gather is
    # O(V^2) per record — quadratic in vocab on the ingest hot path
    y = np.zeros((tgt.shape[0], vocab_size), np.float32)
    y[np.arange(tgt.shape[0]), tgt] = 1.0
    return x, y


class StreamingDataSetIterator(DataSetIterator):
    """Unbounded `DataSetIterator` over a streaming transport topic.

    `normalizer`: an object with ``observe(features)`` and
    ``transform(features)`` (e.g. `online.WindowedStandardize`) — each
    dispatched batch first updates the sliding-window statistics, then
    is transformed with the *current* stats, so the stats a published
    snapshot carries are exactly the ones its training batches saw."""

    def __init__(self, transport, topic: str, *, batch_size: int,
                 record_to_example: Optional[Callable] = None,
                 normalizer=None,
                 watermark_timeout_s: Optional[float] = 10.0,
                 poll_s: float = 0.05,
                 deserialize: Callable = deserialize_ndarray):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.transport = transport
        self.topic = topic
        self._batch = int(batch_size)
        self.record_to_example = record_to_example or _default_example
        self.normalizer = normalizer
        self.watermark_timeout_s = watermark_timeout_s
        self.poll_s = float(poll_s)
        self.deserialize = deserialize
        # offset-addressable fast path: the transport retains messages
        # and serves them by position (LocalLogTransport / Kafka seek)
        self._addressable = hasattr(transport, "read")
        self._next_offset = 0          # next record to READ
        self._consumed_records = 0     # records in batches handed out
        self._consumed_batches = 0
        self._skip_records = 0         # destructive-transport seek debt
        self._held: list = []          # ragged tail awaiting a full batch
        self._stopped = threading.Event()    # per-pass, stop()
        self._abandoned = threading.Event()  # per-pass, abandon()
        self._last_record_ts: Optional[float] = None
        self._metrics_cache = None
        self._lazy_gauge_registry = None   # which registry holds them

    # ------------------------------------------------------------ metrics
    def _metrics(self):
        from deeplearning4j_tpu_torch import monitor
        m = monitor.resolve_cached_metrics(
            self, "_metrics_cache", lambda reg: {
                "records": reg.counter(
                    "streaming_records_consumed_total",
                    "records consumed into dispatched training batches",
                    topic=self.topic),
                "batches": reg.counter(
                    "streaming_batches_total",
                    "fixed-shape batches dispatched to the fit loop",
                    topic=self.topic),
            })
        # the lazy gauges re-bind when enable(registry=) swaps the
        # active registry (identity check, the cached-families pattern)
        if m is not None and self._lazy_gauge_registry \
                is not monitor.registry():
            reg = monitor.registry()
            reg.gauge(
                "streaming_watermark_age_seconds",
                help="seconds since the last record arrived from the "
                     "transport (staleness alarm)",
                topic=self.topic).set_function(self._watermark_age)
            reg.gauge(
                "streaming_lag_records",
                help="producer offset minus consumed offset (NaN when "
                     "the transport has no producer_offset)",
                topic=self.topic).set_function(self._lag)
            self._lazy_gauge_registry = reg
        return m

    def _watermark_age(self) -> float:
        ts = self._last_record_ts
        return float("nan") if ts is None else time.time() - ts

    def _lag(self) -> float:
        fn = getattr(self.transport, "producer_offset", None)
        if fn is None:
            return float("nan")
        try:
            head = int(fn(self.topic))
        except Exception:  # noqa: BLE001 — a broker hiccup must not kill exposition
            return float("nan")
        return float(head - self._consumed_records - len(self._held))

    # ----------------------------------------------------------- control
    def stop(self):
        """End the CURRENT pass gracefully at the next batch boundary
        (records already held back stay held and replay on a later
        pass/resume). Like `abandon()`, the flag is per-pass: a later
        `__iter__` starts a fresh pass — which is what lets one
        OnlineTrainer `run(max_steps=N)` several times over the same
        iterator."""
        self._stopped.set()

    def abandon(self):
        """Abort the CURRENT pass promptly (within one poll slice) —
        the early-abandon hook `AsyncDataSetIterator`'s consumer
        teardown calls so its prefetch thread never stays blocked in a
        watermark wait after the consumer broke out. Re-iterating
        afterwards starts a fresh pass."""
        self._abandoned.set()

    # ------------------------------------------------------------ reading
    def _read_record(self) -> Optional[np.ndarray]:
        """Next raw record, or None when the stream ended (stop /
        abandon / watermark timeout). Blocks in poll_s slices."""
        waited = 0.0
        while True:
            if self._stopped.is_set() or self._abandoned.is_set():
                return None
            try:
                if self._addressable:
                    payload = self.transport.read(
                        self.topic, self._next_offset, timeout=self.poll_s)
                else:
                    payload = self.transport.receive(
                        self.topic, timeout=self.poll_s)
            except (TimeoutError, _queue.Empty):
                waited += self.poll_s
                if (self.watermark_timeout_s is not None
                        and waited >= self.watermark_timeout_s):
                    return None          # stream quiesced
                continue
            self._next_offset += 1
            self._last_record_ts = time.time()
            if self._skip_records > 0:
                # destructive-transport seek: these records were
                # consumed by the interrupted run — drop silently
                self._skip_records -= 1
                continue
            return self.deserialize(payload)

    def _build_batch(self) -> DataSet:
        feats = np.stack([f for f, _ in self._held])
        labels = None
        if self._held[0][1] is not None:
            labels = np.stack([l for _, l in self._held])
        self._held.clear()
        if self.normalizer is not None:
            # window first, transform second: the batch trains under
            # statistics that INCLUDE it (and a snapshot taken after
            # this step carries exactly what training saw)
            self.normalizer.observe(feats)
            feats = self.normalizer.transform(feats)
        return DataSet(feats, labels)

    def __iter__(self):
        self._abandoned.clear()
        self._stopped.clear()
        while True:
            if self._stopped.is_set():
                return
            record = self._read_record()
            if record is None:
                return
            example = self.record_to_example(record)
            if not isinstance(example, tuple):
                example = (example, None)
            if self._held and (
                    np.shape(example[0]) != np.shape(self._held[0][0])
                    or (example[1] is None)
                    != (self._held[0][1] is None)
                    or (example[1] is not None and np.shape(example[1])
                        != np.shape(self._held[0][1]))):
                # a shape change mid-stream can never share a batch
                # with the held tail — fail loudly, a silently dropped
                # tail would break the replay contract
                raise ValueError(
                    f"record shapes (features {np.shape(example[0])}, "
                    f"labels {None if example[1] is None else np.shape(example[1])}) "
                    f"do not match the held batch tail; the "
                    f"unbounded-iterator contract dispatches "
                    f"fixed-shape batches only")
            self._held.append(example)
            if len(self._held) < self._batch:
                continue
            ds = self._build_batch()
            # count BEFORE yielding (fault-runtime cursor contract:
            # code after a yield runs only at the NEXT pull)
            self._consumed_records += self._batch
            self._consumed_batches += 1
            m = self._metrics()
            if m is not None:
                m["records"].inc(self._batch)
                m["batches"].inc()
            yield ds

    # ---------------------------------------------------------- contract
    def cursor(self) -> dict:
        """Position = transport offset. ``batch`` is authoritative
        (the `AsyncDataSetIterator` wrapper rewrites it to its own
        counts-CONSUMED value); ``offset`` is derived from it at
        seek()."""
        return {"kind": "stream", "topic": self.topic,
                "batch": int(self._consumed_batches),
                "batch_size": int(self._batch),
                "offset": int(self._consumed_records)}

    def seek(self, cursor: dict):
        """Replay-from-offset: position the next read at the first
        record after the last CONSUMED batch. Held-back tail records
        and prefetched-but-unconsumed batches replay by construction —
        they never reached the training loop."""
        bs = int(cursor.get("batch_size", self._batch))
        if bs != self._batch:
            raise ValueError(
                f"checkpoint cursor was taken at batch_size {bs}, this "
                f"iterator batches {self._batch} — replay offsets would "
                f"not line up")
        batches = int(cursor["batch"])
        offset = batches * self._batch
        self._consumed_batches = batches
        self._consumed_records = offset
        self._held.clear()
        if self._addressable:
            self._next_offset = offset
            self._skip_records = 0
        else:
            # destructive transport: the log cannot be re-read — skip
            # the consumed prefix of whatever the producer replays
            self._next_offset = 0
            self._skip_records = offset

    def batch_size(self):
        return self._batch
