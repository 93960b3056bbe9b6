"""NDArray pub/sub and the ND4T wire format (counterpart of
`deeplearning4j_tpu/streaming/ndarray.py`).

A payload is a little-endian header (magic ``ND4T``, a dtype code, the
rank, the dims as int64) and the raw buffer, byte for byte the JAX
package's, so either package reads what the other wrote. Codes: 0
float32, 1 float64, 2 int32, 3 int64, 4 bfloat16, 5 int8.

bfloat16 needs no `ml_dtypes`: a `torch.bfloat16` tensor is written
through its int16 view, and a bfloat16 payload decodes to a
`torch.bfloat16` tensor. A numpy array whose dtype is named
``bfloat16`` (another library's) is written through its uint16 view.
Every other dtype decodes to a numpy array, as in JAX. The transports
carry bytes and know nothing of the payload.
"""

from __future__ import annotations

import queue
import struct
from typing import Dict, Optional

import numpy as np
import torch

_MAGIC = b"ND4T"
_BF16 = 4
_DTYPES = {0: np.float32, 1: np.float64, 2: np.int32, 3: np.int64,
           5: np.int8}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}
_NAMES = ["bfloat16"] + [str(np.dtype(d)) for d in _DTYPES.values()]


def _header(code: int, shape) -> bytes:
    return (_MAGIC + struct.pack("<BB", code, len(shape))
            + struct.pack(f"<{len(shape)}q", *shape))


def serialize_ndarray(arr) -> bytes:
    """ND4T bytes of a numpy array or a tensor (a tensor on the card is
    copied to the host)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return (_header(_BF16, tuple(t.shape))
                    + t.view(torch.int16).numpy().tobytes())
        arr = t.numpy()
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return _header(_BF16, arr.shape) + arr.view(np.uint16).tobytes()
    code = _DTYPE_CODES.get(arr.dtype)
    if code is None:
        raise TypeError(f"Unsupported dtype {arr.dtype}; the ND4T wire "
                        f"carries {sorted(_NAMES)}")
    return _header(code, arr.shape) + arr.tobytes()


def deserialize_ndarray(data: bytes):
    """The array of an ND4T payload: a `torch.bfloat16` tensor for code
    4, a numpy array otherwise."""
    if data[:4] != _MAGIC:
        raise ValueError("Not an ND4T payload (bad magic)")
    code, ndim = struct.unpack_from("<BB", data, 4)
    if code != _BF16 and code not in _DTYPES:
        raise ValueError(
            f"Unknown ND4T dtype code {code} (this reader knows codes "
            f"{sorted([_BF16, *_DTYPES])}); payload written by a newer "
            f"wire revision?")
    dims = struct.unpack_from(f"<{ndim}q", data, 6)
    off = 6 + 8 * ndim
    n = int(np.prod(dims))
    if code == _BF16:
        words = np.frombuffer(data, np.int16, n, off).copy()
        return torch.from_numpy(words).view(torch.bfloat16).reshape(dims)
    return np.frombuffer(data, _DTYPES[code], n, off).reshape(dims).copy()


class Transport:
    def send(self, topic: str, payload: bytes) -> None:
        raise NotImplementedError

    def receive(self, topic: str, timeout: Optional[float] = None) -> bytes:
        raise NotImplementedError

    def close(self, topic: str) -> None:
        """Release per-topic resources (consumers, buffers). The fleet
        request plane allocates ONE reply topic per request — without
        this hook a long-lived client leaks a queue (local) or an open
        consumer socket (Kafka) per finished request."""

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class LocalQueueTransport(Transport):
    """In-process transport (the test double of a broker route)."""

    def __init__(self):
        self._queues: Dict[str, queue.Queue] = {}

    def _q(self, topic):
        return self._queues.setdefault(topic, queue.Queue())

    def send(self, topic, payload):
        self._q(topic).put(payload)

    def receive(self, topic, timeout=None):
        return self._q(topic).get(timeout=timeout)

    def close(self, topic):
        self._queues.pop(topic, None)


class LocalLogTransport(Transport):
    """In-process append-only log transport — the offset-addressable
    variant of `LocalQueueTransport` (a Kafka partition's semantics
    without the broker): `send` appends, messages are never destroyed
    by consumption, and `read(topic, offset)` addresses any retained
    message by position.

    A consumer cursor is an offset, so a replay after a crash re-reads
    the same records. `receive()` keeps the Transport contract (one
    shared consumer cursor advancing through the log).
    """

    def __init__(self):
        import threading
        self._logs: Dict[str, list] = {}
        self._cursors: Dict[str, int] = {}
        self._cond = threading.Condition()

    def send(self, topic, payload):
        with self._cond:
            self._logs.setdefault(topic, []).append(payload)
            self._cond.notify_all()

    def producer_offset(self, topic: str) -> int:
        """Messages appended so far — the head the consumer lag
        (`streaming_lag_records`) is measured against."""
        with self._cond:
            return len(self._logs.get(topic, ()))

    def read(self, topic: str, offset: int,
             timeout: Optional[float] = None) -> bytes:
        """Blocking offset-addressed read: the message at `offset`
        (0-based append order), waiting up to `timeout` for the
        producer to reach it. Raises TimeoutError like `receive`."""
        import time as _time
        deadline = None if timeout is None else _time.monotonic() + timeout
        with self._cond:
            while len(self._logs.get(topic, ())) <= offset:
                remaining = (None if deadline is None
                             else deadline - _time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"no message at offset {offset} on {topic}")
                self._cond.wait(remaining if remaining is not None
                                else 1.0)
            return self._logs[topic][offset]

    def receive(self, topic, timeout=None):
        import time as _time
        deadline = None if timeout is None else _time.monotonic() + timeout
        with self._cond:
            # claim-under-lock: concurrent receivers each take a
            # distinct offset (queue semantics over the retained log)
            while len(self._logs.get(topic, ())) <= \
                    self._cursors.get(topic, 0):
                remaining = (None if deadline is None
                             else deadline - _time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(f"No message on {topic}")
                self._cond.wait(remaining if remaining is not None
                                else 1.0)
            off = self._cursors.get(topic, 0)
            self._cursors[topic] = off + 1
            return self._logs[topic][off]

    def close(self, topic):
        with self._cond:
            self._logs.pop(topic, None)
            self._cursors.pop(topic, None)


class KafkaTransport(Transport):
    """Kafka-backed transport; requires kafka-python (not bundled)."""

    def __init__(self, bootstrap_servers: str):
        try:
            from kafka import KafkaConsumer, KafkaProducer  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "KafkaTransport needs the kafka-python package; install it "
                "or use LocalQueueTransport") from e
        from kafka import KafkaProducer
        self._producer = KafkaProducer(bootstrap_servers=bootstrap_servers)
        self._bootstrap = bootstrap_servers
        self._consumers: Dict[str, object] = {}

    def send(self, topic, payload):
        self._producer.send(topic, payload)
        self._producer.flush()

    def receive(self, topic, timeout=None):
        from kafka import KafkaConsumer
        if topic not in self._consumers:
            self._consumers[topic] = KafkaConsumer(
                topic, bootstrap_servers=self._bootstrap,
                auto_offset_reset="earliest")
        ms = int((timeout or 10) * 1000)
        batch = self._consumers[topic].poll(timeout_ms=ms, max_records=1)
        for records in batch.values():
            return records[0].value
        raise TimeoutError(f"No message on {topic}")

    def read(self, topic: str, offset: int,
             timeout: Optional[float] = None) -> bytes:
        """Offset-addressed read through a dedicated seeking consumer
        (untested here: no broker runs beside the tests)."""
        from kafka import KafkaConsumer, TopicPartition
        key = f"{topic}\x00seek"
        if key not in self._consumers:
            c = KafkaConsumer(bootstrap_servers=self._bootstrap)
            c.assign([TopicPartition(topic, 0)])
            self._consumers[key] = c
        c = self._consumers[key]
        c.seek(TopicPartition(topic, 0), int(offset))
        ms = int((timeout or 10) * 1000)
        batch = c.poll(timeout_ms=ms, max_records=1)
        for records in batch.values():
            return records[0].value
        raise TimeoutError(f"No message at offset {offset} on {topic}")

    def producer_offset(self, topic: str) -> int:
        """The partition's end offset (producer head) — the lag
        gauge's reference point."""
        from kafka import KafkaConsumer, TopicPartition
        c = KafkaConsumer(bootstrap_servers=self._bootstrap)
        try:
            tp = TopicPartition(topic, 0)
            return int(c.end_offsets([tp])[tp])
        finally:
            c.close()

    def close(self, topic):
        for key in (topic, f"{topic}\x00seek"):
            consumer = self._consumers.pop(key, None)
            if consumer is not None:
                consumer.close()


class NDArrayPublisher:
    def __init__(self, transport: Transport, topic: str):
        self.transport = transport
        self.topic = topic

    def publish(self, arr: np.ndarray):
        self.transport.send(self.topic, serialize_ndarray(arr))


class NDArrayConsumer:
    def __init__(self, transport: Transport, topic: str):
        self.transport = transport
        self.topic = topic

    def consume(self, timeout: Optional[float] = None) -> np.ndarray:
        return deserialize_ndarray(self.transport.receive(self.topic, timeout))
