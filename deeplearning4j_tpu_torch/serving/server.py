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
(`_spec_proposers`).

SLO shedding: with `slo_ttft_s` set, a request whose projected queue
delay (outstanding decode tokens over the dispatch-time EWMA of tokens
a second) exceeds the SLO fails at once with `ShedError` instead of
queueing into certain lateness; `max_queue` is the hard backstop. Both
count in `serving_shed_total`, in the SLO's bad counter (with `slo=`)
and on the request's trace.

Monitoring (`monitor.enable()`): each request carries a `RequestTrace`
(queued, prefill and decode phases, shed, preempt and drain events),
and the scheduler mirrors the engine's host counters, the goodput
ledger and the SLO tracker onto the registry under the JAX package's
family names (`serving_*`, `slo_*`; a named server labels its series
`server=<name>`). All of it is host bookkeeping on values the scheduler
already holds: monitoring on emits the same tokens with the same
device-to-host copies as monitoring off.
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

from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.monitor.flightrec import GLOBAL_FLIGHT_RECORDER
from deeplearning4j_tpu_torch.monitor.goodput import (
    GOODPUT_COUNTER_FAMILIES,
    GOODPUT_FRACTION_GAUGE,
    ttft_decomposition,
)
from deeplearning4j_tpu_torch.monitor.reqtrace import RequestTrace
from deeplearning4j_tpu_torch.monitor.slo import SLOObjective, SLOTracker
from deeplearning4j_tpu_torch.serving.engine import (
    PagedDecodeEngine,
    bucket_len,
)
from deeplearning4j_tpu_torch.serving.paged import blocks_needed
from deeplearning4j_tpu_torch.zoo.transformer import check_ids

_DONE = object()
_IDLE_WAIT_S = 0.05      # scheduler park on an empty queue
_log = logging.getLogger(__name__)


class ShedError(RuntimeError):
    """Request fast-failed by the SLO admission policy (shed, not
    queued): retry elsewhere or with backoff."""


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
        # the request's trace (None with monitoring off and no upstream
        # context): the scheduler stamps phases on it, finish/fail seal it
        self.trace: Optional[RequestTrace] = None
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
        if self.trace is not None:
            # a no-op after the scheduler's own finish (ttft, slo)
            self.trace.finish(
                status="cancelled" if self.cancelled else "ok",
                tokens=len(self.tokens))
        self._close()

    def _fail(self, exc: BaseException):
        if not self._fut.done():
            self._fut.set_exception(exc)
        self._q.put(_DONE)
        if self.trace is not None:
            self.trace.finish(
                status="shed" if isinstance(exc, ShedError) else "error",
                error=type(exc).__name__)
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
    """Continuous-batching autoregressive serving over a paged KV pool
    (the JAX server's constructor, lifecycle and scheduler; `device`
    names the card). Two JAX arguments are not taken: `idle_wait_s` is
    a constant here, and `dispatch_floor_s`, a floor under each
    dispatch that emulates a slower device for CPU load tests, has no
    use on the card."""

    def __init__(self, net, *, n_slots: int = 8, n_blocks: int = 64,
                 block_len: int = 16, top_k: Optional[int] = None,
                 steps_per_dispatch: int = 1,
                 slo_ttft_s: Optional[float] = None,
                 max_queue: Optional[int] = None,
                 quantize: Optional[str] = None,
                 allocation: str = "incremental",
                 speculative: Optional[int] = None,
                 spec_accept_floor: float = 0.3,
                 spec_probe_every: int = 50,
                 spec_sampled: bool = False,
                 spec_draft_layers: Optional[int] = None,
                 prefix_cache: str = "registered",
                 name: Optional[str] = None,
                 slo: Optional[SLOObjective] = None, device="cuda"):
        # `serving_*` series carry `server=<name>` when named, so two
        # servers in one process do not collide
        self.name = name
        # good/bad counters and the burn rate, per finished request
        # (a shed counts as bad)
        self._slo_tracker = (SLOTracker(slo, model=name or "default")
                             if slo is not None else None)
        self._slo_cache = None
        # shed bursts reach the flight recorder at most once a second
        self._shed_recent = 0
        self._shed_last_emit = 0.0
        self.engine = PagedDecodeEngine(
            net, n_slots=n_slots, n_blocks=n_blocks, block_len=block_len,
            top_k=top_k, steps_per_dispatch=steps_per_dispatch,
            quantize=quantize, allocation=allocation,
            speculative=speculative, spec_sampled=spec_sampled,
            spec_draft_layers=spec_draft_layers, prefix_cache=prefix_cache,
            device=device)
        self._metrics_cache = None
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
        # registry mirror cursors of the engine's host counters
        self._prefix_hits_seen = 0
        self._prefix_saved_seen = 0
        self._radix_hits_seen = 0
        self._radix_evict_seen = 0
        self._goodput_seen = {}
        self._grants_seen = 0
        self._requeue_seen = 0
        # prefix registrations from other threads, applied by the
        # scheduler (the engine is single-threaded)
        self._control: "queue.Queue" = queue.Queue()
        self.slo_ttft_s = slo_ttft_s
        self.max_queue = max_queue
        self._queue: "queue.Queue" = queue.Queue()
        self._pending: List = []
        self._slot2req = {}
        # the shedding estimator: EWMA of the decode tokens a second
        self._ewma_tok_s: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._draining = False
        self._stopped = False
        self._open_streams = 0
        self._queued_tokens = 0
        self._open_lock = threading.Lock()

    # ------------------------------------------------------- bookkeeping
    def _stream_closed(self):
        with self._open_lock:
            self._open_streams -= 1

    @property
    def open_streams(self) -> int:
        """Streams submitted and not yet finished or failed."""
        with self._open_lock:
            return self._open_streams

    @property
    def queued_tokens(self) -> int:
        """Tokens owed by requests still in the submit queue: a running
        count, so a router reads it without walking the queue."""
        with self._open_lock:
            return max(0, self._queued_tokens)

    def queue_depth(self) -> int:
        """Requests awaiting admission (the submit queue and the pending
        list; `serving_queue_depth`), at most one iteration stale."""
        return len(self._pending) + self._queue.qsize()

    def _queue_item_taken(self, item):
        if item is None:
            return
        with self._open_lock:
            self._queued_tokens -= int(getattr(item[0], "n_tokens", 0))

    def output_async(self, x):
        """Not supported: the scheduler queue carries generation
        requests, not feature batches."""
        raise NotImplementedError(
            "GenerationServer serves token streams: use "
            "generate_async(prompt_ids, n_tokens); for single-shot "
            "batched forwards use ParallelInference")

    # ------------------------------------------------------------ warmup
    def warmup(self, prompt_len, n_tokens: int = 2):
        """Drive, before `start()`, the JAX server's warmup grid: an
        admission wave of every power-of-two width up to the slot count
        at every power-of-two length bucket up to the prompt's, greedy
        and with a sampled head, each decoded out (chunked dispatches),
        and the truncated drafter once; so the kernels are built and the
        device libraries initialised before the first request. All of
        it goes to the goodput ledger's `warmup` class, and the engine's
        traffic counters restart at 0.

        `prompt_len` may also be a ``(shortest, longest)`` pair of the
        traffic's prompt lengths: the grid then covers only the buckets
        from the shortest's to the longest's, the only ones that traffic
        pads to (the port builds no program per bucket, so the smaller
        buckets warm nothing it will use)."""
        if self._running:
            raise RuntimeError("warmup() must run before start()")
        eng = self.engine
        n_tokens = max(2, int(n_tokens))
        if isinstance(prompt_len, (tuple, list)):
            shortest, prompt_len = (int(n) for n in prompt_len)
        else:
            shortest = 1
        eng.check_budget(int(prompt_len), n_tokens)
        widths, w = [], 1
        while w < eng.n_slots:
            widths.append(w)
            w *= 2
        widths.append(eng.n_slots)
        top_bucket = bucket_len(int(prompt_len), eng.max_total_tokens)
        buckets, b = [], 1
        while b <= top_bucket:
            buckets.append(b)
            b *= 2
        if buckets[-1] != top_bucket:
            buckets.append(top_bucket)
        low = bucket_len(shortest, eng.max_total_tokens)
        buckets = [b for b in buckets if b >= low]
        # the zero prompts must neither ride nor seed the prefix caches
        saved = eng._prefixes, eng._radix
        eng._prefixes, eng._radix = {}, None
        short_wave = None
        eng.goodput.set_mode("warmup")
        try:
            for k in widths:
                for pl in buckets:
                    pw = int(pl)
                    n_b = min(n_tokens, eng.max_total_tokens - pw)
                    if n_b < 1:
                        # the budget-clamped top bucket: a one-shorter
                        # prompt pads to it all the same
                        pw, n_b = pw - 1, 1
                        if pw < 1:
                            continue
                    for sampled_head in (False, True):
                        reqs = [dict(prompt_ids=np.zeros(pw, np.int64),
                                     n_tokens=n_b) for _ in range(k)]
                        if sampled_head:
                            reqs[0].update(temperature=1.0,
                                           rng=np.zeros(2, np.uint32))
                        admitted = eng.admit_many(reqs)
                        while eng.active.any():
                            eng.step(speculate=False)
                        eng.drain_preempted()
                        for slot, _, done in admitted:
                            if not done and eng.slots[slot] is not None:
                                eng.evict(slot)
                        if len(admitted) < k and short_wave is None:
                            short_wave = (len(admitted), k)
                if short_wave is not None:
                    _log.warning(
                        "warmup admitted only %d of a width-%d wave (pool "
                        "%d blocks): wider waves were not warmed",
                        short_wave[0], short_wave[1], eng.pool.n_blocks)
                    break
            if eng._draft_plan is not None:
                eng._run_draft([])       # every lane on the garbage block
        finally:
            eng._prefixes, eng._radix = saved
            eng.goodput.set_mode(None)
        # the grid's grants and preemptions are not traffic
        for name in ("block_grants_total", "evict_requeue_total",
                     "prefix_forks_total", "prefix_hits_total",
                     "prefix_tokens_saved_total", "radix_hit_tokens_total",
                     "radix_evictions_total", "spec_draft_dispatches_total"):
            setattr(eng, name, 0)
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

    def _drain_control(self, eng) -> bool:
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
                fut.set_result(eng.register_prefix(arg))
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
                       rng=None, emit_start: int = 0,
                       trace: Optional[RequestTrace] = None) -> TokenStream:
        """Enqueue one request; returns its token stream. `rng` is the
        sampling key (a [2] uint32 key, or an int seed meaning
        `PRNGKey(seed)`); a sampled request without one draws a fresh
        random key, as the JAX server does. `emit_start` continues a
        stream begun elsewhere (its sampled folds keep their positions).
        `trace` carries upstream trace context; with monitoring on and
        none given, a trace is minted here. Tracing is host timestamps
        only: it never touches the keys or the card."""
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
        if trace is None and monitor.is_enabled():
            trace = RequestTrace(model=self.name)
        if trace is not None:
            trace.annotate(prompt_len=int(prompt.shape[0]),
                           n_tokens=int(n_tokens))
            if trace.model is None:
                trace.model = self.name
        stream.trace = trace
        with self._open_lock:
            # the drain flag is re-checked under the lock drain() sets it
            # with, so no request slips into a server already drained
            if self._draining:
                raise ServerDrainingError("GenerationServer is draining")
            self._open_streams += 1
            self._queued_tokens += int(n_tokens)
        req = _Request(prompt, int(n_tokens), float(temperature), top_p, rng,
                       stream, emit_base=emit_start)
        self._queue.put((req, fut, stream.t_submit))
        return stream

    # -------------------------------------------- queued-request migration
    def export_queued(self) -> List:
        """Take every request still in the submit queue (nothing emitted,
        no state here) for another server's `adopt_queued`; requests the
        scheduler has seen finish here. Their streams stay open but stop
        counting toward this server's `drain()`."""
        items = []
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            self._queue_item_taken(item)
            if item is not None:
                items.append(item)
        if items:
            with self._open_lock:
                self._open_streams -= len(items)
        return items

    def adopt_queued(self, items) -> int:
        """Adopt requests another server exported: the same streams and
        futures, this server now owes them. Returns how many."""
        if not items:
            return 0
        if self._stopped:
            raise RuntimeError("GenerationServer is stopped")
        if self._draining:
            raise ServerDrainingError(
                "cannot adopt migrated requests into a draining server")
        for item in items:
            req = item[0]
            req.stream._on_close = self._stream_closed
            tr = req.stream.trace
            if tr is not None:
                tr.event("migrated", to=self.name)
            with self._open_lock:
                self._open_streams += 1
                self._queued_tokens += int(req.n_tokens)
            self._queue.put(item)
        return len(items)

    # ----------------------------------------------------------- metrics
    def _serving_metrics(self):
        return monitor.resolve_cached_metrics(self, "_metrics_cache",
                                              self._build_serving_metrics)

    def _build_serving_metrics(self, reg):
        lbl = {"server": self.name} if self.name else {}
        fams = {
            "queue": reg.gauge("serving_queue_depth",
                               "generation requests awaiting admission",
                               **lbl),
            "slots": reg.gauge("serving_active_slots",
                               "serving slots decoding right now", **lbl),
            "blocks": reg.gauge("serving_free_blocks",
                                "free KV-pool blocks", **lbl),
            "requests": reg.counter("serving_requests_total",
                                    "generation requests admitted",
                                    **lbl),
            "tokens": reg.counter("serving_tokens_total",
                                  "tokens emitted by the decode loop",
                                  **lbl),
            "shed": reg.counter("serving_shed_total",
                                "requests fast-failed by the SLO "
                                "admission policy", **lbl),
            "evicted": reg.counter("serving_evicted_total",
                                   "sequences evicted mid-stream", **lbl),
            "pool_free": reg.gauge("serving_pool_blocks_free",
                                   "free KV-pool blocks (allocator "
                                   "view)", **lbl),
            "pool_used": reg.gauge("serving_pool_blocks_used",
                                   "granted KV-pool blocks", **lbl),
            "grants": reg.counter("serving_block_grants_total",
                                  "pool blocks granted (admission + "
                                  "lazy decode growth)", **lbl),
            "requeue": reg.counter("serving_evict_requeue_total",
                                   "pool-pressure preemptions requeued "
                                   "as continuations", **lbl),
            "spec_accept": reg.gauge(
                "serving_spec_accept_rate",
                "EWMA of the draft-token acceptance rate (speculative "
                "decoding; drives the auto-disable policy)", **lbl),
            "spec_tpd": reg.gauge(
                "serving_spec_tokens_per_dispatch",
                "EWMA of tokens emitted per speculative dispatch",
                **lbl),
            "prefix_shared": reg.gauge(
                "serving_prefix_blocks_shared",
                "pool blocks currently mapped by more than one holder "
                "(shared-prefix CoW)", **lbl),
            "prefix_hits": reg.counter(
                "serving_prefix_hits_total",
                "admissions that mapped a registered shared prefix "
                "instead of prefilling it", **lbl),
            "prefix_saved": reg.counter(
                "serving_prefix_tokens_saved_total",
                "prompt tokens NOT prefilled thanks to shared-prefix "
                "block reuse", **lbl),
            "spec_accept_by": {
                p: reg.gauge(
                    "serving_spec_accept_rate",
                    "EWMA of the draft-token acceptance rate (speculative "
                    "decoding; drives the auto-disable policy)",
                    proposer=p, **lbl)
                for p in ("ngram", "truncated")},
            "spec_proposed_by": {
                p: reg.counter(
                    "serving_spec_proposed_total",
                    "draft tokens offered to the verify dispatch",
                    proposer=p, **lbl)
                for p in ("ngram", "truncated")},
            "spec_accepted_by": {
                p: reg.counter(
                    "serving_spec_accepted_total",
                    "draft tokens accepted by the verify dispatch",
                    proposer=p, **lbl)
                for p in ("ngram", "truncated")},
            "radix_nodes": reg.gauge(
                "serving_radix_nodes",
                "radix prefix-cache tree nodes currently held", **lbl),
            "radix_hits": reg.counter(
                "serving_radix_hit_tokens_total",
                "prompt tokens matched in the radix prefix cache "
                "instead of prefilled", **lbl),
            "radix_evict": reg.counter(
                "serving_radix_evictions_total",
                "radix prefix-cache nodes evicted under pool pressure",
                **lbl),
            "ttft": reg.timer("serving_ttft_seconds",
                              "submit-to-first-token latency", **lbl),
            "tpot": reg.timer("serving_tpot_seconds",
                              "mean per-token decode latency per "
                              "finished request", **lbl),
            "step": reg.timer("serving_step_seconds",
                              "one continuous-batching decode dispatch",
                              **lbl),
            "goodput_frac": reg.gauge(
                GOODPUT_FRACTION_GAUGE,
                "useful token-positions / dispatched token-positions "
                "(the goodput ledger's rolling fraction)", **lbl),
            "goodput": {
                c: reg.counter(
                    fam, f"dispatched token-positions classified "
                         f"{c} by the goodput ledger", **lbl)
                for c, fam in GOODPUT_COUNTER_FAMILIES.items()
            },
            "ttft_queue": reg.timer(
                "serving_ttft_queue_wait_seconds",
                "TTFT decomposition: submit to admission wave", **lbl),
            "ttft_prefill": reg.timer(
                "serving_ttft_prefill_seconds",
                "TTFT decomposition: the admission dispatch", **lbl),
            "ttft_emit": reg.timer(
                "serving_ttft_first_emit_seconds",
                "TTFT decomposition: prefill completion to the consumer "
                "seeing the first token", **lbl),
        }
        # "no evidence yet" reads healthy: an acceptance gauge at the
        # registry's default 0 would trip a collapse alert on a fresh
        # server
        fams["spec_accept"].set(1.0)
        for g in fams["spec_accept_by"].values():
            g.set(1.0)
        return fams

    def _slo_metrics(self):
        return monitor.resolve_cached_metrics(self, "_slo_cache",
                                              self._build_slo_metrics)

    def _build_slo_metrics(self, reg):
        lbl = {"model": self.name or "default"}
        return {
            "good": reg.counter("slo_requests_good_total",
                                "finished requests meeting the SLO",
                                **lbl),
            "bad": reg.counter("slo_requests_bad_total",
                               "requests missing the SLO (sheds "
                               "included)", **lbl),
            "burn": reg.gauge("slo_burn_rate",
                              "rolling-window error-budget burn rate "
                              "(1.0 = sustainable)", **lbl),
        }

    # ---------------------------------------------------------- shedding
    def _outstanding_tokens(self) -> int:
        """Outstanding decode work: the live slots' remaining tokens
        and, per pending request, the tokens it still owes plus its
        prompt's blocks as a prefill cost."""
        eng = self.engine
        out = int(eng.remaining[eng.active].sum())
        for req, _, _ in self._pending:
            out += req.n_left + blocks_needed(
                len(req.prompt) + req.emitted, eng.block_len)
        return out

    def _should_shed(self, req) -> Optional[str]:
        if self.max_queue is not None and len(self._pending) >= self.max_queue:
            return (f"admission queue full ({len(self._pending)} >= "
                    f"max_queue {self.max_queue})")
        if self.slo_ttft_s is not None and self._ewma_tok_s:
            projected = self._outstanding_tokens() / self._ewma_tok_s
            if projected > self.slo_ttft_s:
                return (f"projected queue delay {projected:.2f}s exceeds "
                        f"the {self.slo_ttft_s:.2f}s TTFT SLO at "
                        f"{self._ewma_tok_s:.1f} tok/s")
        return None

    # --------------------------------------------------------- scheduler
    def _collect_loop(self):
        eng = self.engine
        while self._running:
            try:
                progressed = self._schedule_once(eng)
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
                self._queue_item_taken(item)
                if item is not None:
                    self._pending.append(item)

    def _fail_all(self, exc: BaseException):
        self.engine.drain_preempted()
        for slot, (req, _, _) in list(self._slot2req.items()):
            if self.engine.slots[slot] is not None:
                self.engine.evict(slot)
            req.stream._fail(exc)
        self._slot2req.clear()
        for req, _, _ in self._pending:
            req.stream._fail(exc)
        self._pending.clear()

    def _shed(self, req, reason: str, m):
        if m is not None:
            m["shed"].inc()
        self._note_shed(req, reason)
        req.stream._fail(ShedError(reason))

    def _schedule_once(self, eng) -> bool:
        m = self._serving_metrics()
        progressed = self._drain_control(eng)
        # ------------------------------------------------ cancellations
        for slot, (req, _, _) in list(self._slot2req.items()):
            if req.stream.cancelled:
                eng.evict(slot)
                del self._slot2req[slot]
                if m is not None:
                    m["evicted"].inc()
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
            self._queue_item_taken(item)
            if item is None:
                continue
            req = item[0]
            if req.stream.cancelled:
                req.stream._finish()
                continue
            reason = self._should_shed(req)
            if reason is not None:
                self._shed(req, reason, m)
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
                    self._shed(head, str(e), m)
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
            t0p = time.perf_counter()
            admitted = eng.admit_many([
                dict(prompt_ids=it[0].effective_prompt(),
                     n_tokens=it[0].n_left, request_id=id(it[0]),
                     temperature=it[0].temperature, top_p=it[0].top_p,
                     rng=it[0].rng,
                     emit_start=it[0].emit_base + it[0].emitted)
                for it in wave])
            if not admitted:
                break
            t1p = time.perf_counter()
            now = time.monotonic()
            for (slot, first, done), (req, fut, t_submit) in zip(admitted,
                                                                 wave):
                self._pending.pop(0)
                fresh = req.stream.t_first is None
                req.stream._emit_many([first], now)
                tr = req.stream.trace
                if tr is not None:
                    info = eng.admit_info.get(slot) or {}
                    if fresh:
                        tr.phase("queued", tr.t_created, t0p)
                    tr.phase("prefill", t0p, t1p, wave_width=len(admitted),
                             slot=slot, continuation=not fresh, **info)
                    if info.get("cow_fork"):
                        tr.event("cow_fork", slot=slot)
                if m is not None:
                    m["tokens"].inc()
                    if fresh:
                        # a requeued continuation was counted (and its
                        # TTFT observed) at its first admission
                        m["requests"].inc()
                        m["ttft"].observe(now - t_submit)
                if done:
                    self._finish(req, m)
                else:
                    self._slot2req[slot] = (req, fut, t_submit)
            progressed = True
        # -------------------------------------------------------- decode
        if eng.active.any():
            t0 = time.perf_counter()
            emitted, finished = eng.step(speculate=self._spec_policy(),
                                         proposers=self._spec_proposers())
            t1 = time.perf_counter()
            dt = t1 - t0
            # the dispatch's speculative deltas for the traces, read
            # before _spec_update moves the cursors
            d_spec_prop = eng.spec_proposed_total - self._spec_proposed_seen
            d_spec_acc = eng.spec_accepted_total - self._spec_accepted_seen
            self._spec_update(m)
            now = time.monotonic()
            preempted = eng.drain_preempted()
            if preempted:
                requeued = []
                for note in preempted:
                    entry = self._slot2req.pop(note["slot"], None)
                    if entry is not None:
                        requeued.append(entry)
                        tr = entry[0].stream.trace
                        if tr is not None:
                            tr.event("preempt_requeue",
                                     emitted=int(note.get("emitted", 0)))
                self._pending[:0] = requeued
            n_tok = sum(len(ts) for ts in emitted.values())
            if m is not None and n_tok:
                m["step"].observe(dt)
                m["tokens"].inc(n_tok)
            if n_tok and dt > 0:
                rate = n_tok / dt
                self._ewma_tok_s = (rate if self._ewma_tok_s is None
                                    else 0.8 * self._ewma_tok_s
                                    + 0.2 * rate)
            for slot, toks in emitted.items():
                stream = self._slot2req[slot][0].stream
                stream._emit_many(toks, now)
                tr = stream.trace
                if tr is not None:
                    args = {"tokens": len(toks)}
                    if d_spec_prop:
                        args["spec_proposed"] = d_spec_prop
                        args["spec_accepted"] = d_spec_acc
                    tr.phase("decode", t0, t1, **args)
            for slot in finished:
                req, _, _ = self._slot2req.pop(slot)
                self._finish(req, m)
            progressed = True
        if m is not None:
            self._publish_gauges(eng, m)
        return progressed

    def _publish_gauges(self, eng, m):
        """Mirror the engine's host counters, the pool and the goodput
        ledger onto the registry (deltas since the last call)."""
        m["queue"].set(self.queue_depth())
        m["slots"].set(eng.active_slots)
        m["blocks"].set(eng.free_blocks)
        m["pool_free"].set(eng.pool.free_blocks)
        m["pool_used"].set(eng.pool.used_blocks)
        if eng.block_grants_total > self._grants_seen:
            m["grants"].inc(eng.block_grants_total - self._grants_seen)
            self._grants_seen = eng.block_grants_total
        if eng.evict_requeue_total > self._requeue_seen:
            m["requeue"].inc(eng.evict_requeue_total - self._requeue_seen)
            self._requeue_seen = eng.evict_requeue_total
        if eng.has_prefixes or eng.prefix_hits_total:
            m["prefix_shared"].set(eng.pool.allocator.shared_blocks)
            if eng.prefix_hits_total > self._prefix_hits_seen:
                m["prefix_hits"].inc(eng.prefix_hits_total
                                     - self._prefix_hits_seen)
                m["prefix_saved"].inc(eng.prefix_tokens_saved_total
                                      - self._prefix_saved_seen)
                self._prefix_saved_seen = eng.prefix_tokens_saved_total
                self._prefix_hits_seen = eng.prefix_hits_total
        if eng._radix is not None:
            m["radix_nodes"].set(eng._radix.nodes)
            if eng.radix_hit_tokens_total > self._radix_hits_seen:
                m["radix_hits"].inc(eng.radix_hit_tokens_total
                                    - self._radix_hits_seen)
                self._radix_hits_seen = eng.radix_hit_tokens_total
            if eng.radix_evictions_total > self._radix_evict_seen:
                m["radix_evict"].inc(eng.radix_evictions_total
                                     - self._radix_evict_seen)
                self._radix_evict_seen = eng.radix_evictions_total
        gp = eng.goodput
        for cls, ctr in m["goodput"].items():
            total = gp.classes[cls]
            seen = self._goodput_seen.get(cls, 0)
            if total > seen:
                ctr.inc(total - seen)
                self._goodput_seen[cls] = total
        m["goodput_frac"].set(gp.goodput_fraction())

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

    def _spec_update(self, m=None):
        """Fold the engine's speculative counters since the last call
        into the acceptance EWMAs (alpha 0.2), flip the latch, and
        mirror them onto `m` (the serving families, None with
        monitoring off). A dispatch that drafted nothing counts as
        acceptance 0: it paid the k-wide score for one token a slot."""
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
            d_pp, d_pa = tot_p - pp, tot_a - pa
            self._spec_prop_seen[prop] = (tot_p, tot_a)
            if d_pp > 0:
                prev = self._spec_prop_ewma[prop]
                self._spec_prop_ewma[prop] = (
                    d_pa / d_pp if prev is None
                    else 0.8 * prev + 0.2 * d_pa / d_pp)
                if m is not None:
                    m["spec_proposed_by"][prop].inc(d_pp)
                    if d_pa > 0:
                        m["spec_accepted_by"][prop].inc(d_pa)
                    m["spec_accept_by"][prop].set(
                        self._spec_prop_ewma[prop])
        if m is not None:
            m["spec_accept"].set(self._spec_accept_ewma)
            if self._spec_tpd_ewma is not None:
                m["spec_tpd"].set(self._spec_tpd_ewma)

    # ------------------------------------------------------ finish, shed
    def _note_shed(self, req, reason: str):
        """A shed beyond its counter: the reason on the request's trace,
        the SLO's bad count and burn rate, and a flight-recorder event
        at most once a second."""
        tr = req.stream.trace
        if tr is not None:
            tr.event("shed", reason=reason)
        slo = self._slo_tracker
        if slo is not None:
            slo.record_shed()
            sm = self._slo_metrics()
            if sm is not None:
                sm["bad"].inc()
                sm["burn"].set(slo.burn_rate())
        self._shed_recent += 1
        now = time.monotonic()
        if now - self._shed_last_emit >= 1.0:
            GLOBAL_FLIGHT_RECORDER.record(
                "shed_burst", server=self.name,
                count=self._shed_recent, reason=reason)
            self._shed_recent = 0
            self._shed_last_emit = now

    def _finish(self, req, m):
        """Close a finished request: TTFT and TPOT on its trace, the SLO
        verdict, the TPOT timer and the TTFT decomposition."""
        st = req.stream
        n = len(st.tokens)
        ttft = (st.t_first - st.t_submit) if st.t_first is not None \
            else None
        tpot = ((st.t_last - st.t_first) / (n - 1)
                if st.t_first is not None and n > 1 else None)
        tr = st.trace
        if tr is not None:
            if self._draining:
                tr.event("drain_at_swap")
            tr.annotate(ttft_s=ttft, tpot_s=tpot)
        slo = self._slo_tracker
        if slo is not None:
            good = slo.record(ttft=ttft, tpot=tpot)
            sm = self._slo_metrics()
            if sm is not None:
                sm["good" if good else "bad"].inc()
                sm["burn"].set(slo.burn_rate())
            if tr is not None:
                tr.annotate(slo_good=good)
        st._finish()
        if m is not None and tpot is not None:
            m["tpot"].observe(tpot)
        if m is not None and tr is not None:
            dec = ttft_decomposition(tr)
            if dec is not None:
                m["ttft_queue"].observe(dec["queue_wait_s"])
                m["ttft_prefill"].observe(dec["prefill_s"])
                m["ttft_emit"].observe(dec["first_emit_s"])

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
        finished. True when drained, False on timeout. The dispatches
        from here on count in the goodput ledger's `drain` class."""
        with self._open_lock:
            self._draining = True
        self.engine.goodput.set_mode("drain")
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
            self._queue_item_taken(item)
            if item is not None:
                self._pending.append(item)
        for slot, (req, _, _) in list(self._slot2req.items()):
            if not alive and self.engine.slots[slot] is not None:
                self.engine.evict(slot)
            req.stream._fail(RuntimeError(
                "GenerationServer stopped before this request finished"))
        self._slot2req.clear()
        for req, _, _ in self._pending:
            req.stream._fail(RuntimeError(
                "GenerationServer stopped before this request was admitted"))
        self._pending.clear()
        self._fail_control()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
