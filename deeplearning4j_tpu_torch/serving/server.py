"""Continuous-batching generation server (counterpart of
`deeplearning4j_tpu/serving/server.py`: `GenerationServer` :212,
`TokenStream` :67).

`generate_async(prompt, n_tokens) -> TokenStream` from any thread; one
scheduler thread (started by `start()`) owns the engine. Each loop
iteration reaps cancellations, admits a FIFO wave of queued prompts
into free slots, advances every active slot one dispatch, streams the
new tokens and retires finished sequences. Pool-pressure preemptions
requeue at the head of the line as continuations (prompt + emitted).
`max_queue` sheds with `ShedError`.

The engine's options pass through (`quantize`, `allocation`,
`speculative` and its `spec_*`, `prefix_cache`). `register_prefix`
applies directly before `start()` and through a control queue the
scheduler drains on a running server. Speculation is governed per
dispatch: an acceptance-rate EWMA turns drafting off below
`spec_accept_floor` and a probe dispatch every `spec_probe_every`
re-measures (`_spec_policy`); with the truncated drafter configured, a
collapsed n-gram EWMA hands drafting to the drafter alone
(`_spec_proposers`). SLO shedding (`slo_ttft_s`), tracing and the
metrics mirrors are later slices; the constructor takes none of their
arguments.
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
                 max_queue: Optional[int] = None,
                 quantize: Optional[str] = None,
                 allocation: str = "incremental",
                 speculative: Optional[int] = None,
                 spec_accept_floor: float = 0.3,
                 spec_probe_every: int = 50,
                 spec_sampled: bool = False,
                 spec_draft_layers: Optional[int] = None,
                 prefix_cache: str = "registered", device="cuda"):
        self.engine = PagedDecodeEngine(
            net, n_slots=n_slots, n_blocks=n_blocks, block_len=block_len,
            top_k=top_k, steps_per_dispatch=steps_per_dispatch,
            quantize=quantize, allocation=allocation,
            speculative=speculative, spec_sampled=spec_sampled,
            spec_draft_layers=spec_draft_layers, prefix_cache=prefix_cache,
            device=device)
        # speculation policy: drafting pays a k-wide score, so it stays
        # on only while the acceptance EWMA is at or above the floor; a
        # probe dispatch every `spec_probe_every` re-measures
        self.spec_accept_floor = float(spec_accept_floor)
        self.spec_probe_every = max(1, int(spec_probe_every))
        self._spec_accept_ewma: Optional[float] = None
        self._spec_tpd_ewma: Optional[float] = None
        self._spec_disabled = False
        self._spec_probe_in = 0
        self._spec_proposed_seen = 0
        self._spec_accepted_seen = 0
        self._spec_emitted_seen = 0
        self._spec_dispatches_seen = 0
        # per-proposer EWMAs: a collapsed n-gram cache hands drafting to
        # the truncated drafter instead of disabling speculation
        self._spec_prop_ewma = {"ngram": None, "truncated": None}
        self._spec_prop_seen = {"ngram": (0, 0), "truncated": (0, 0)}
        # prefix registrations from other threads, applied by the
        # scheduler (the engine is single-threaded)
        self._control: "queue.Queue" = queue.Queue()
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
        # the zero prompts must neither ride nor seed the prefix caches;
        # every other decode mode is driven once below
        saved = eng._prefixes, eng._radix
        eng._prefixes, eng._radix = {}, None
        try:
            for k in widths:
                for sampled_head in (False, True):
                    reqs = [dict(prompt_ids=np.zeros(pl, np.int64),
                                 n_tokens=n_b) for _ in range(k)]
                    if sampled_head:
                        reqs[0].update(temperature=1.0, rng=0)
                    admitted = eng.admit_many(reqs)
                    spec = None if eng.spec_k is None else False
                    while eng.active.any():
                        eng.step(speculate=spec)
                        spec = None     # a chunked, then a spec dispatch
                    eng.drain_preempted()
                    for slot, _, done in admitted:
                        if not done and eng.slots[slot] is not None:
                            eng.evict(slot)
                    if len(admitted) < k:
                        _log.warning("warmup admitted %d of a width-%d "
                                     "wave (pool %d blocks)",
                                     len(admitted), k, eng.pool.n_blocks)
        finally:
            eng._prefixes, eng._radix = saved
        for name in ("block_grants_total", "evict_requeue_total",
                     "prefix_forks_total", "prefix_hits_total",
                     "prefix_tokens_saved_total", "radix_hit_tokens_total",
                     "radix_evictions_total", "spec_dispatches_total",
                     "spec_proposed_total", "spec_accepted_total",
                     "spec_emitted_total", "spec_draft_dispatches_total"):
            setattr(eng, name, 0)
        eng.spec_proposed_by = {"ngram": 0, "truncated": 0}
        eng.spec_accepted_by = {"ngram": 0, "truncated": 0}
        return self

    # ------------------------------------------------------ shared prefix
    def register_prefix(self, token_ids, *,
                        timeout: Optional[float] = 600.0) -> tuple:
        """Prefill a shared prompt prefix into the pool once
        (`PagedDecodeEngine.register_prefix`). Before `start()` it
        applies directly; on a running server it goes through the
        control queue the scheduler drains, and this call blocks until
        it is applied. Returns the registry key."""
        if self._stopped:
            raise RuntimeError("GenerationServer is stopped")
        if not self._running:
            return self.engine.register_prefix(token_ids)
        fut: Future = Future()
        self._control.put(("register_prefix", token_ids, fut))
        # a stop() between the checks above and the put has already
        # drained the queue: drain once more so the future resolves
        if self._stopped or not self._running:
            self._fail_control()
        return fut.result(timeout)

    def _drain_control(self) -> bool:
        progressed = False
        while True:
            try:
                op, arg, fut = self._control.get_nowait()
            except queue.Empty:
                return progressed
            progressed = True
            try:
                if op != "register_prefix":
                    raise ValueError(f"unknown control op {op!r}")
                fut.set_result(self.engine.register_prefix(arg))
            except Exception as e:  # noqa: BLE001 — surfaced to the caller
                if not fut.done():
                    fut.set_exception(e)

    def _fail_control(self):
        while True:
            try:
                _, _, fut = self._control.get_nowait()
            except queue.Empty:
                return
            if not fut.done():
                fut.set_exception(RuntimeError(
                    "GenerationServer stopped before the control request "
                    "was applied"))

    # ------------------------------------------------------------ submit
    def generate_async(self, prompt_ids, n_tokens: int, *,
                       temperature: float = 0.0,
                       top_p: Optional[float] = None,
                       rng=None,
                       emit_start: int = 0) -> TokenStream:
        """Enqueue one request; returns its token stream. `rng` is the
        sampling key (a [2] uint32 key, or an int seed meaning
        `PRNGKey(seed)`); a sampled request without one draws a fresh
        random key, as the JAX server does."""
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
        self.engine.check_budget(int(prompt.shape[0]), int(n_tokens),
                                 prompt_ids=prompt)
        if top_p is not None and not 0.0 < float(top_p) <= 1.0:
            raise ValueError(f"top_p must be in (0, 1]; got {top_p}")
        if temperature < 0:
            raise ValueError(f"temperature must be >= 0; got {temperature}")
        if temperature > 0 and rng is None:
            rng = np.frombuffer(os.urandom(8), np.uint32).copy()
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
        progressed = self._drain_control()
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
            prefixed = eng.has_prefixes or eng._radix is not None
            head_ids = head.effective_prompt() if prefixed else None
            if not eng.can_admit(len(head.prompt) + head.emitted,
                                 head.n_left, prompt_ids=head_ids):
                # a head that can never be admitted sheds rather than
                # wedge the FIFO queue behind it
                try:
                    eng.check_budget(len(head.prompt) + head.emitted,
                                     head.n_left,
                                     prompt_ids=head.effective_prompt())
                except ValueError as e:
                    self._pending.pop(0)
                    head.stream._fail(ShedError(str(e)))
                    progressed = True
                    continue
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
            emitted, finished = eng.step(speculate=self._spec_policy(),
                                         proposers=self._spec_proposers())
            self._spec_update()
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

    # ------------------------------------------------ speculative policy
    def _spec_policy(self) -> Optional[bool]:
        """Whether the next dispatch drafts: None (the engine's default)
        without speculation, True while it is healthy; while the
        acceptance EWMA sits under the floor, False except for one probe
        every `spec_probe_every`."""
        if not self.engine.spec_k:
            return None
        if not self._spec_disabled:
            return True
        self._spec_probe_in -= 1
        if self._spec_probe_in <= 0:
            self._spec_probe_in = self.spec_probe_every
            return True                      # probe dispatch
        return False

    def _spec_proposers(self) -> Optional[tuple]:
        """("truncated",) when the drafter is configured and the n-gram
        proposer's own EWMA fell under the floor while the drafter's did
        not; None (every proposer) otherwise."""
        eng = self.engine
        if not eng.spec_k or eng._draft_plan is None:
            return None
        ng = self._spec_prop_ewma["ngram"]
        tr = self._spec_prop_ewma["truncated"]
        if ng is not None and ng < self.spec_accept_floor \
                and (tr is None or tr >= self.spec_accept_floor):
            return ("truncated",)
        return None

    def _spec_update(self):
        """Fold the engine's speculative counters since the last call
        into the acceptance EWMAs (alpha 0.2) and flip the latch. A
        dispatch that drafted nothing counts as acceptance 0: it paid
        the k-wide score for one token a slot."""
        eng = self.engine
        if not eng.spec_k:
            return
        d_prop = eng.spec_proposed_total - self._spec_proposed_seen
        d_acc = eng.spec_accepted_total - self._spec_accepted_seen
        d_emit = eng.spec_emitted_total - self._spec_emitted_seen
        d_disp = eng.spec_dispatches_total - self._spec_dispatches_seen
        self._spec_proposed_seen = eng.spec_proposed_total
        self._spec_accepted_seen = eng.spec_accepted_total
        self._spec_emitted_seen = eng.spec_emitted_total
        self._spec_dispatches_seen = eng.spec_dispatches_total
        if d_disp < 1:
            return                           # a chunked dispatch
        rate = d_acc / d_prop if d_prop > 0 else 0.0
        self._spec_accept_ewma = (
            rate if self._spec_accept_ewma is None
            else 0.8 * self._spec_accept_ewma + 0.2 * rate)
        self._spec_tpd_ewma = (
            d_emit / d_disp if self._spec_tpd_ewma is None
            else 0.8 * self._spec_tpd_ewma + 0.2 * d_emit / d_disp)
        if not self._spec_disabled \
                and self._spec_accept_ewma < self.spec_accept_floor:
            self._spec_disabled = True
            self._spec_probe_in = self.spec_probe_every
        elif self._spec_disabled \
                and self._spec_accept_ewma >= self.spec_accept_floor:
            self._spec_disabled = False
        for prop in ("ngram", "truncated"):
            pp, pa = self._spec_prop_seen[prop]
            tot_p = eng.spec_proposed_by[prop]
            tot_a = eng.spec_accepted_by[prop]
            self._spec_prop_seen[prop] = (tot_p, tot_a)
            if tot_p - pp > 0:
                r = (tot_a - pa) / (tot_p - pp)
                prev = self._spec_prop_ewma[prop]
                self._spec_prop_ewma[prop] = (
                    r if prev is None else 0.8 * prev + 0.2 * r)

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
        self._fail_control()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
