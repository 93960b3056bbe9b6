"""Streaming serve/publish routes (counterpart of
`deeplearning4j_tpu/streaming/routes.py`).

Reference: `dl4j-streaming/.../routes/DL4jServeRouteBuilder.java` (a
Camel route: consume serialized NDArrays from a Kafka topic → optional
pre-processor → restore model → `output()` → optional final processor →
publish to the output URI) and `CamelKafkaRouteBuilder.java` (records →
serialized arrays → topic). Camel's role — wiring transports to
processors — is plain composition here over the same `Transport`
abstraction (`streaming/ndarray.py`: LocalQueue or Kafka), so the
routes run identically on the in-memory transport in tests and on a
real broker in production.
"""

from __future__ import annotations

import threading
from typing import Callable, Iterable, Optional

import numpy as np

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.streaming.ndarray import (
    NDArrayConsumer,
    NDArrayPublisher,
    Transport,
)


class ServingRoute:
    """consume(topic) → before → route through the fleet router →
    final → publish(topic).

    `model`: anything with `.output(x)` (MultiLayerNetwork or
    ComputationGraph — pass `model_uri` instead to lazy-restore from a
    checkpoint zip, the reference's `modelUri` mode).

    The forward itself goes through a `FleetRouter` output backend
    (`serving/router.py`) — the route is a transport adapter over the
    same front end the generation fleet uses, so a plain forward-
    serving route shares the router's per-model request accounting
    (`fleet_output_requests_total{model=}`), its `max_queue` shed
    backstop, and (when `router=` is a shared instance) a single
    admission plane with the generation models. By default each route
    owns a private single-model router named `model_name`.

    `device`: where a `model_uri` checkpoint is restored (the card
    unless the caller asks for the CPU); asking for the card without
    one raises here, before anything is consumed."""

    def __init__(self, transport: Transport, consuming_topic: str,
                 output_topic: str, model=None, model_uri: Optional[str] = None,
                 before: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                 final: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                 router=None, model_name: Optional[str] = None,
                 max_queue: Optional[int] = None, device="cuda"):
        if model is None and model_uri is None:
            raise ValueError("need model or model_uri")
        self.device = resolve_device(device)
        self.transport = transport
        self.consuming_topic = consuming_topic
        self.output_topic = output_topic
        self._model = model
        self.model_uri = model_uri
        self.before = before
        self.final = final
        self.model_name = model_name or f"route:{consuming_topic}"
        if router is None:
            from deeplearning4j_tpu_torch.serving.router import FleetRouter
            router = FleetRouter(max_queue=max_queue)
        self.router = router
        self._attached = False
        self._consumer = NDArrayConsumer(transport, consuming_topic)
        self._publisher = NDArrayPublisher(transport, output_topic)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def model(self):
        if self._model is None:
            from deeplearning4j_tpu_torch.util.serializer import (
                ModelSerializer)
            self._model = ModelSerializer.restore_model(
                self.model_uri, device=self.device)
        return self._model

    def _router_backend(self):
        """Attach the (possibly lazily-restored) model to the router as
        an output backend exactly once."""
        if not self._attached:
            self.router.attach_output(self.model_name, self.model)
            self._attached = True
        return self.router

    # ---------------------------------------------------------- processing
    def process_one(self, timeout: Optional[float] = None) -> bool:
        """One exchange through the route; False on consume timeout.
        Transport/deserialization errors propagate — an empty topic and
        a broken broker must not look the same."""
        import queue as _queue
        try:
            x = self._consumer.consume(timeout=timeout)
        except (TimeoutError, _queue.Empty):
            return False
        if x is None:
            return False
        if self.before is not None:
            x = self.before(x)
        out = self._router_backend().route_output(self.model_name, x)
        if self.final is not None:
            out = self.final(out)
        self._publisher.publish(np.asarray(out))
        return True

    def run(self, max_messages: Optional[int] = None,
            timeout: Optional[float] = 1.0) -> int:
        """Drain the topic (until timeout or max_messages). Returns the
        number of messages served."""
        served = 0
        while max_messages is None or served < max_messages:
            if self._stop.is_set() or not self.process_one(timeout=timeout):
                break
            served += 1
        return served

    # ------------------------------------------------------- background run
    def start(self, poll_timeout: float = 0.2):
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, args=(poll_timeout,), daemon=True)
        self._thread.start()
        return self

    def _loop(self, poll_timeout):
        import logging
        while not self._stop.is_set():
            try:
                self.process_one(timeout=poll_timeout)
            except Exception:
                # background serving must survive transient broker
                # errors; log and keep polling (reference Camel route
                # error-handler role)
                logging.getLogger(__name__).exception(
                    "serving route error (continuing)")
                self._stop.wait(poll_timeout)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


class RecordPublishRoute:
    """records → feature arrays → topic (reference
    `CamelKafkaRouteBuilder` record-serialize-publish leg)."""

    def __init__(self, transport: Transport, topic: str,
                 extractor: Optional[Callable] = None):
        self.publisher = NDArrayPublisher(transport, topic)
        self.extractor = extractor or (lambda r: np.asarray(r, np.float32))

    def publish(self, records: Iterable) -> int:
        n = 0
        for rec in records:
            self.publisher.publish(np.asarray(self.extractor(rec)))
            n += 1
        return n
