"""ParallelInference: batched serving over a mesh's data axis
(counterpart of `deeplearning4j_tpu/parallel/inference.py`).

Many small `output()` requests coalesce into device-sized batches (the
reference's `ObservablesProvider`): a collector thread gathers the
requests that arrive within `queue_limit_ms` (up to `batch_limit`
rows), pads the batch to a bucket (a power of two that divides by the
data axis, as JAX pads so XLA sees few shapes), splits its rows over
the replicas, runs each block through the model's `output()` on its
replica's device, and hands every caller its rows. On a mesh that
repeats one card the blocks run one after the other.

Metrics (while monitoring is on, the JAX names): the enqueue-to-result
latency timer, the queue depth gauge and the executed batch-size
histogram, all host arithmetic on values already read back (no device
sync of their own).
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.parallel.mesh import data_devices, device_mesh


class ParallelInference:
    def __init__(self, model, mesh=None, *, batch_limit: int = 64,
                 queue_limit_ms: float = 5.0, data_axis: str = "data"):
        self.model = model
        self.mesh = mesh if mesh is not None else device_mesh()
        self.batch_limit = batch_limit
        self.queue_limit_ms = queue_limit_ms
        self.data_axis = data_axis
        self.devices = data_devices(self.mesh, data_axis)
        self._nets = None
        self._nets_version = None
        self._lock = threading.Lock()
        self._buckets = [1, 2, 4, 8, 16, 32, 64, 128, 256]
        self._queue: "queue.Queue" = queue.Queue()
        self._collector: Optional[threading.Thread] = None
        self._running = False
        self._shutdown = False
        # executed batch sizes: the observable proof of coalescing
        self.batch_size_history = deque(maxlen=1024)

    def _replicas(self):
        """One net per replica: the model on its own device, a copy
        refreshed from it (when its params changed) on any other."""
        with self._lock:
            if self._nets is None or (
                    self._nets_version != self.model.params_version):
                nets = []
                for d in self.devices:
                    if d == self.model.device:
                        nets.append(self.model)
                    else:
                        nets.append(self.model.copy().to(d))
                self._nets = nets
                self._nets_version = self.model.params_version
            return self._nets

    def _metrics(self):
        from deeplearning4j_tpu_torch import monitor
        return monitor.resolve_cached_metrics(
            self, "_metrics_by_registry", lambda reg: (
                reg.timer("inference_request_latency_seconds",
                          "enqueue-to-result latency per output_async "
                          "request"),
                reg.gauge("inference_queue_depth",
                          "requests waiting to join a coalesced batch"),
                reg.histogram("inference_batch_size",
                              "rows per executed device batch",
                              buckets=(1, 2, 4, 8, 16, 32, 64, 128,
                                       256, 512))))

    def _bucket(self, n: int) -> int:
        mesh_n = self.mesh.shape[self.data_axis]
        for b in self._buckets:
            if b >= n and b % mesh_n == 0:
                return b
        return ((n + mesh_n - 1) // mesh_n) * mesh_n

    def output(self, x):
        """One call: the batch padded to a bucket that divides by the
        data axis, its row blocks through the replicas, the padding cut
        off. Returns a host array."""
        x = np.asarray(x)
        n = x.shape[0]
        b = self._bucket(n)
        if b != n:
            pad = np.zeros((b - n,) + x.shape[1:], x.dtype)
            x = np.concatenate([x, pad], axis=0)
        nets = self._replicas()
        rows = b // len(nets)
        outs = []
        with torch.no_grad():
            for r, net in enumerate(nets):
                o = net.output(x[r * rows:(r + 1) * rows])
                outs.append(o.float().to("cpu"))
        return torch.cat(outs).numpy()[:n]

    # -------------------------------------------- background batching loop
    def start(self) -> "ParallelInference":
        """Start the collector thread: concurrent `output_async` callers
        coalesce into one batch within `queue_limit_ms`."""
        if self._shutdown:
            raise RuntimeError("ParallelInference is shut down")
        if self._running:
            return self
        self._replicas()
        self._running = True
        self._collector = threading.Thread(target=self._collect_loop,
                                           daemon=True)
        self._collector.start()
        return self

    def stop(self):
        self._running = False
        if self._collector is not None:
            self._queue.put(None)
            self._collector.join(timeout=5)
            self._collector = None
        self._fail_pending()

    def _fail_pending(self):
        """Fail every request that never joined a batch (a caller blocked
        in `.result()` must not hang)."""
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item[1].done():
                item[1].set_exception(
                    RuntimeError("ParallelInference stopped before this "
                                 "request was executed"))

    def shutdown(self):
        """Stop for good: the enqueue side closes first, every pending
        Future fails, and `output_async` refuses from then on."""
        self._shutdown = True
        self.stop()
        self._fail_pending()

    def __enter__(self):
        return self.start()

    def __exit__(self, *a):
        self.stop()

    def output_async(self, x) -> Future:
        """Enqueue one request; its Future resolves with this request's
        rows once the batch it joined has run."""
        if self._shutdown:
            raise RuntimeError("ParallelInference is shut down")
        if not self._running:
            raise RuntimeError("call start() before output_async()")
        fut: Future = Future()
        self._queue.put((np.asarray(x), fut, time.monotonic()))
        if self._shutdown:
            self._fail_pending()
        return fut

    def _collect_loop(self):
        while self._running:
            m = self._metrics()
            if m is not None:
                m[1].set(self._queue.qsize())
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            if first is None:
                continue
            batch = [first]
            total = first[0].shape[0]
            deadline = time.monotonic() + self.queue_limit_ms / 1000.0
            while total < self.batch_limit:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    break
                batch.append(nxt)
                total += nxt[0].shape[0]
            self._execute(batch)

    def _execute(self, batch):
        futs = [item[1] for item in batch]
        try:
            n_rows = sum(item[0].shape[0] for item in batch)
            self.batch_size_history.append(n_rows)
            outs = self.output_batched([item[0] for item in batch])
            done_t = time.monotonic()
            m = self._metrics()
            if m is not None:
                m[2].observe(n_rows)
            for item, o in zip(batch, outs):
                item[1].set_result(o)
                if m is not None and len(item) > 2:
                    m[0].observe(done_t - item[2])
        except Exception as e:  # noqa: BLE001 — to every waiting caller
            for f in futs:
                if not f.done():
                    f.set_exception(e)

    def output_batched(self, requests: List[np.ndarray]):
        """Many requests as one batch, the results split back out."""
        sizes = [np.asarray(r).shape[0] for r in requests]
        merged = np.concatenate([np.asarray(r) for r in requests], axis=0)
        out = self.output(merged)
        result, off = [], 0
        for s in sizes:
            result.append(out[off:off + s])
            off += s
        return result
