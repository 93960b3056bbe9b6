"""Continuous-batching generation server (counterpart of
`deeplearning4j_tpu/serving/server.py`: `GenerationServer` :212,
`TokenStream` :67).

`generate_async(prompt, n_tokens) -> TokenStream` from any thread; one
scheduler thread (started by `start()`) owns the engine. Each loop
iteration reaps cancellations, admits a FIFO wave of queued prompts
into free slots, advances every active slot one dispatch, streams the
new tokens and retires finished sequences. Pool-pressure preemptions
requeue at the head of the line as continuations (prompt + emitted).
`max_queue` sheds with `ShedError`. SLO shedding, tracing, metrics,
prefix registration and speculation are later slices; the constructor
takes none of their arguments.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from concurrent.futures import Future
from typing import Iterator, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.serving.engine import (
    PagedDecodeEngine,
    bucket_len,
)
from deeplearning4j_tpu_torch.zoo.transformer import check_ids

_DONE = object()
_IDLE_WAIT_S = 0.05      # scheduler park on an empty queue
_log = logging.getLogger(__name__)


class ShedError(RuntimeError):
    """Request fast-failed by admission control (shed, not queued)."""


class ServerDrainingError(RuntimeError):
    """Admission refused because the server is draining."""


class ServerStoppedError(RuntimeError):
    """`start()` after `stop()`: build a fresh server instead."""


class TokenStream:
    """Per-request token stream: iterate for tokens as they decode, or
    block on `result()` for the full array."""

    def __init__(self, fut: Future, prompt_len: int, n_tokens: int,
                 on_close=None):
        self._fut = fut
        self._q: "queue.Queue" = queue.Queue()
        self.prompt_len = prompt_len
        self.n_tokens = n_tokens
        self.tokens: List[int] = []
        self.cancelled = False
        self.t_submit = time.monotonic()
        self.t_first: Optional[float] = None
        self.t_last: Optional[float] = None
        self._on_close = on_close
        self._closed = False

    def __iter__(self) -> Iterator[int]:
        while True:
            item = self._q.get()
            if item is _DONE:
                exc = self._fut.exception(timeout=0)
                if exc is not None and not self.cancelled:
                    raise exc
                return
            yield from item       # one wakeup per dispatch chunk

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        return self._fut.result(timeout)

    def cancel(self):
        """Evict mid-stream at the next scheduler iteration; `result()`
        resolves with the tokens emitted so far."""
        self.cancelled = True

    def _emit_many(self, toks, now: float):
        if not toks:
            return
        if self.t_first is None:
            self.t_first = now
        self.t_last = now
        toks = [int(t) for t in toks]
        self.tokens.extend(toks)
        self._q.put(toks)

    def _close(self):
        if not self._closed:
            self._closed = True
            if self._on_close is not None:
                self._on_close()

    def _finish(self):
        if not self._fut.done():
            self._fut.set_result(np.asarray(self.tokens, np.int64))
        self._q.put(_DONE)
        self._close()

    def _fail(self, exc: BaseException):
        if not self._fut.done():
            self._fut.set_exception(exc)
        self._q.put(_DONE)
        self._close()


class _Request:
    __slots__ = ("prompt", "n_tokens", "temperature", "top_p", "rng",
                 "stream", "emit_base")

    def __init__(self, prompt, n_tokens, temperature, top_p, rng, stream,
                 emit_base=0):
        self.prompt = prompt
        self.n_tokens = n_tokens
        self.temperature = temperature
        self.top_p = top_p
        self.rng = rng
        self.stream = stream
        self.emit_base = int(emit_base)

    def effective_prompt(self):
        """Prompt extended by every token already streamed (the
        continuation a preempted request re-admits with)."""
        done = self.stream.tokens
        if not done:
            return self.prompt
        return np.concatenate([self.prompt, np.asarray(done, np.int64)])

    @property
    def emitted(self) -> int:
        return len(self.stream.tokens)

    @property
    def n_left(self) -> int:
        return self.n_tokens - self.emitted


class GenerationServer:
    """Continuous-batching autoregressive serving over a paged KV pool."""

    def __init__(self, net, *, n_slots: int = 8, n_blocks: int = 64,
                 block_len: int = 16, top_k: Optional[int] = None,
                 steps_per_dispatch: int = 1,
                 max_queue: Optional[int] = None, device="cuda"):
        self.engine = PagedDecodeEngine(
            net, n_slots=n_slots, n_blocks=n_blocks, block_len=block_len,
            top_k=top_k, steps_per_dispatch=steps_per_dispatch,
            device=device)
        self.max_queue = max_queue
        self._queue: "queue.Queue" = queue.Queue()
        self._pending: List = []
        self._slot2req = {}
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._draining = False
        self._stopped = False
        self._open_streams = 0
        self._open_lock = threading.Lock()

    # ------------------------------------------------------- bookkeeping
    def _stream_closed(self):
        with self._open_lock:
            self._open_streams -= 1

    @property
    def open_streams(self) -> int:
        with self._open_lock:
            return self._open_streams

    # ------------------------------------------------------------ warmup
    def warmup(self, prompt_len: int, n_tokens: int = 2):
        """Run one admission wave of every power-of-two width up to the
        slot count (greedy, and with a sampled head) at the prompt's
        length bucket, and decode it out — before `start()`, so the
        kernels are built and the device libraries initialised before
        the first real request."""
        if self._running:
            raise RuntimeError("warmup() must run before start()")
        eng = self.engine
        n_tokens = max(2, int(n_tokens))
        eng.check_budget(int(prompt_len), n_tokens)
        widths, w = [], 1
        while w < eng.n_slots:
            widths.append(w)
            w *= 2
        widths.append(eng.n_slots)
        pl = bucket_len(int(prompt_len), eng.max_total_tokens)
        n_b = min(n_tokens, eng.max_total_tokens - pl)
        if n_b < 1:
            pl, n_b = pl - 1, 1
        for k in widths:
            for sampled_head in (False, True):
                reqs = [dict(prompt_ids=np.zeros(pl, np.int64), n_tokens=n_b)
                        for _ in range(k)]
                if sampled_head:
                    reqs[0].update(temperature=1.0, rng=0)
                admitted = eng.admit_many(reqs)
                while eng.active.any():
                    eng.step()
                eng.drain_preempted()
                for slot, _, done in admitted:
                    if not done and eng.slots[slot] is not None:
                        eng.evict(slot)
                if len(admitted) < k:
                    _log.warning("warmup admitted %d of a width-%d wave "
                                 "(pool %d blocks)", len(admitted), k,
                                 eng.pool.n_blocks)
        eng.block_grants_total = 0
        eng.evict_requeue_total = 0
        return self

    # ------------------------------------------------------------ submit
    def generate_async(self, prompt_ids, n_tokens: int, *,
                       temperature: float = 0.0,
                       top_p: Optional[float] = None,
                       rng: Optional[int] = None,
                       emit_start: int = 0) -> TokenStream:
        """Enqueue one request; returns its token stream. `rng` is the
        sampling seed (an int); a sampled request without one draws a
        fresh random seed."""
        if self._stopped:
            raise RuntimeError("GenerationServer is stopped")
        if self._draining:
            raise ServerDrainingError("GenerationServer is draining")
        if not self._running:
            raise RuntimeError("call start() before generate_async()")
        prompt = np.asarray(prompt_ids)
        if prompt.ndim == 2 and prompt.shape[0] == 1:
            prompt = prompt[0]
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError(f"prompt must be a non-empty 1-D id "
                             f"sequence; got shape {prompt.shape}")
        prompt = prompt.astype(np.int64)
        check_ids(prompt, self.engine.vocab)
        self.engine.check_budget(int(prompt.shape[0]), int(n_tokens))
        if top_p is not None and not 0.0 < float(top_p) <= 1.0:
            raise ValueError(f"top_p must be in (0, 1]; got {top_p}")
        if temperature < 0:
            raise ValueError(f"temperature must be >= 0; got {temperature}")
        if temperature > 0 and rng is None:
            rng = int.from_bytes(os.urandom(7), "little")
        fut: Future = Future()
        stream = TokenStream(fut, int(prompt.shape[0]), int(n_tokens),
                             on_close=self._stream_closed)
        with self._open_lock:
            # the drain flag is re-checked under the lock drain() sets it
            # with, so no request slips into a server already drained
            if self._draining:
                raise ServerDrainingError("GenerationServer is draining")
            self._open_streams += 1
        req = _Request(prompt, int(n_tokens), float(temperature), top_p, rng,
                       stream, emit_base=emit_start)
        self._queue.put((req, fut))
        return stream

    # --------------------------------------------------------- scheduler
    def _collect_loop(self):
        while self._running:
            try:
                progressed = self._schedule_once()
            except Exception as e:  # noqa: BLE001 — a failed dispatch must
                # fail every waiting consumer, not hang them
                _log.exception("scheduler iteration failed")
                self._fail_all(e)
                continue
            if not progressed:
                try:
                    item = self._queue.get(timeout=_IDLE_WAIT_S)
                except queue.Empty:
                    continue
                if item is not None:
                    self._pending.append(item)

    def _fail_all(self, exc: BaseException):
        self.engine.drain_preempted()
        for slot, (req, _) in list(self._slot2req.items()):
            if self.engine.slots[slot] is not None:
                self.engine.evict(slot)
            req.stream._fail(exc)
        self._slot2req.clear()
        for req, _ in self._pending:
            req.stream._fail(exc)
        self._pending.clear()

    def _shed(self, req) -> Optional[str]:
        if self.max_queue is not None and len(self._pending) >= self.max_queue:
            return (f"admission queue full ({len(self._pending)} >= "
                    f"max_queue {self.max_queue})")
        return None

    def _schedule_once(self) -> bool:
        eng = self.engine
        progressed = False
        # ------------------------------------------------ cancellations
        for slot, (req, _) in list(self._slot2req.items()):
            if req.stream.cancelled:
                eng.evict(slot)
                del self._slot2req[slot]
                req.stream._finish()
                progressed = True
        if any(item[0].stream.cancelled for item in self._pending):
            for item in self._pending:
                if item[0].stream.cancelled:
                    item[0].stream._finish()
            self._pending = [it for it in self._pending
                             if not it[0].stream.cancelled]
            progressed = True
        # --------------------------------------------------- admissions
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is None:
                continue
            req = item[0]
            if req.stream.cancelled:
                req.stream._finish()
                continue
            reason = self._shed(req)
            if reason is not None:
                req.stream._fail(ShedError(reason))
                continue
            self._pending.append(item)
        while self._pending:
            head = self._pending[0][0]
            if not eng.can_admit(len(head.prompt) + head.emitted):
                break                     # FIFO: never leapfrog the head
            wave = []
            for item in self._pending:
                if item[0].stream.cancelled:
                    break
                wave.append(item)
                if len(wave) >= eng.free_slots:
                    break
            admitted = eng.admit_many([
                dict(prompt_ids=it[0].effective_prompt(),
                     n_tokens=it[0].n_left, request_id=id(it[0]),
                     temperature=it[0].temperature, top_p=it[0].top_p,
                     rng=it[0].rng,
                     emit_start=it[0].emit_base + it[0].emitted)
                for it in wave])
            if not admitted:
                break
            now = time.monotonic()
            for (slot, first, done), (req, fut) in zip(admitted, wave):
                self._pending.pop(0)
                req.stream._emit_many([first], now)
                if done:
                    req.stream._finish()
                else:
                    self._slot2req[slot] = (req, fut)
            progressed = True
        # -------------------------------------------------------- decode
        if eng.active.any():
            emitted, finished = eng.step()
            now = time.monotonic()
            preempted = eng.drain_preempted()
            if preempted:
                requeued = [self._slot2req.pop(n["slot"]) for n in preempted
                            if n["slot"] in self._slot2req]
                self._pending[:0] = requeued
            for slot, toks in emitted.items():
                self._slot2req[slot][0].stream._emit_many(toks, now)
            for slot in finished:
                req, _ = self._slot2req.pop(slot)
                req.stream._finish()
            progressed = True
        return progressed

    # --------------------------------------------------------- lifecycle
    def start(self):
        if self._stopped:
            raise ServerStoppedError(
                "GenerationServer was stopped; build a fresh server")
        if self._running:
            return self
        self._running = True
        self._thread = threading.Thread(target=self._collect_loop,
                                        name="generation-scheduler",
                                        daemon=True)
        self._thread.start()
        return self

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Close admissions (new `generate_async` raises
        `ServerDrainingError`) and wait until every submitted stream has
        finished. True when drained, False on timeout."""
        with self._open_lock:
            self._draining = True
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.open_streams > 0:
            if not self._running:
                return self.open_streams == 0
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(0.002)
        return True

    def stop(self):
        """Stop the scheduler and fail whatever is queued or in flight."""
        if self._stopped:
            return
        self._stopped = True
        self._running = False
        alive = False
        if self._thread is not None:
            self._queue.put(None)                  # wake an idle park
            self._thread.join(timeout=600)
            alive = self._thread.is_alive()
            self._thread = None
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                self._pending.append(item)
        for slot, (req, _) in list(self._slot2req.items()):
            if not alive and self.engine.slots[slot] is not None:
                self.engine.evict(slot)
            req.stream._fail(RuntimeError(
                "GenerationServer stopped before this request finished"))
        self._slot2req.clear()
        for req, _ in self._pending:
            req.stream._fail(RuntimeError(
                "GenerationServer stopped before this request was admitted"))
        self._pending.clear()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
