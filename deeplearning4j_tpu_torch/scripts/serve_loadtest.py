"""Serving load test on the port: continuous batching vs sequential
generate() (counterpart of `scripts/serve_loadtest.py`).

    python -m deeplearning4j_tpu_torch.scripts.serve_loadtest [--smoke]
        [--device cuda|cpu] [--out build/drivers/serving.json]

Drives an EVENT-DRIVEN client harness against a `GenerationServer` on a
TransformerLM: all requests are submitted from one thread and awaited
through their `TokenStream` future faces, with TTFT taken from the
stream's producer-side timestamps — no per-stream OS thread. The
sequential baseline runs under the same thread-free harness. Wall
windows close after a `torch.cuda.synchronize` on the card.

Three phases, one ledger with JAX's block names and keys
(`extras.serving` + `extras.serving_mixed_quantized`, written to
`--out`, by default `build/drivers/serving.json`; never a committed
`BENCH_*.json`, which are the TPU package's records):

1. uniform-length greedy burst — continuous aggregate tok/s vs
   sequential B=1 `generate()` round-trips, p50/p99 TTFT, greedy parity;
2. MIXED-LENGTH prompts against an int8-QUANTIZED server
   (`quantize="int8"`, incremental block allocation) — bucketed
   admission waves, quantized tok/s, mixed-length TTFT, the decode
   program's weight-byte reduction (`nd/quant.py` +
   `PagedDecodeEngine.decode_cost_report`), and the incremental-vs-
   upfront admission-concurrency A/B;
3. deliberate overload proving the SLO shedding path fires.

Then, as JAX's default run does: the fleet (4), the replicas (10,
`--skip-fleet`/`--skip-replicated` skip them), speculation and the
shared prefix (5, 6), sampled speculation, the truncated drafter and
the radix cache (7-9); `--skip-spec` (the port's own flag) skips 5-9.
`--spec-smoke`, `--sampled-spec-smoke`, `--trace-smoke`,
`--alert-smoke`, `--fleet-smoke` and `--replica-smoke` run one mode
alone, as JAX's do.

Hard asserts (exit nonzero):

- greedy parity: every stream bit-equal to its whole-batch
  `generate()` row — fp phase AND quantized phase (vs
  `generate(quantize="int8")`), staggered admissions included. Both
  sides run in the port on one device with the same kernels; a stream
  that first differs at a near-tie of its reference (`torch.matmul` is
  not batch-invariant) is held by `zoo.transformer.stream_agreement`
  at `NEAR_TIE_EPS`, and each such stream is recorded with its margin
  in the ledger (`near_ties`);
- continuous aggregate tokens/s beats sequential round-trips;
- decode weight-byte reduction >= 3.5x (full config; the smoke
  model's tiny d_model bounds it lower, >= 2.5x);
- incremental allocation admits >= 2x the up-front-grant baseline's
  concurrent streams at the same pool size;
- mixed-length waves actually admit heterogeneous prompt lengths;
- p99 TTFT bounded; the overload phase sheds at least one request.

What the port's smokes do not do as JAX's do:

- the `compare_bench` self-gates of the spec, sampled-spec and alert
  smokes wait for the port's `bench.py` (the benchmark harness); each
  smoke prints one line naming the gate check as not yet ported and
  keeps every other hard assert;
- the replicas' scale gate: JAX's `--replica-min-scale` measures
  overlap against `--replica-step-floor-ms`, an emulated CPU dispatch
  floor the port's server does not have, and on one card the replicas
  share the device. The port reports `replica_scale_x` and does not
  assert it, and has neither flag (the ledger's `step_floor_ms` is
  null).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import threading
import time

import numpy as np

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.scripts import _common


#: a stream that first differs from its reference where the reference's
#: top-1/top-2 probability gap is at most this is a near-tie (fp32
#: batch variance of the decode's matmuls), not a broken stream
NEAR_TIE_EPS = 1e-4


def build_net(vocab, d_model, n_layers, n_heads, max_len, seed=11, *,
              device="cuda"):
    from deeplearning4j_tpu_torch.zoo.transformer import TransformerLM
    return TransformerLM(vocab_size=vocab, d_model=d_model,
                         n_layers=n_layers, n_heads=n_heads,
                         max_len=max_len, seed=seed).init(device=device)


def greedy_parity(net, prompts, refs, got, *, quantize=None, ties=None):
    """Greedy streams against their references, within the port: True
    when every stream is bit-equal, or differs first at a near-tie of its
    reference (`stream_agreement` at `NEAR_TIE_EPS`). Each near-tie
    stream is appended to `ties` as (stream, position, top-2 margin)."""
    from deeplearning4j_tpu_torch.zoo.transformer import (
        stream_agreement, teacher_forced_probs)
    ok = True
    for i, (p, r, g) in enumerate(zip(prompts, refs, got)):
        if g is not None and np.array_equal(np.asarray(r, np.int64),
                                            np.asarray(g, np.int64)):
            continue
        if g is None:
            ok = False
            continue
        probs = teacher_forced_probs(net, p, r, quantize=quantize)
        rep = stream_agreement(r, g, probs, NEAR_TIE_EPS)
        if not rep["ok"]:
            ok = False
        elif ties is not None:
            top = np.sort(probs[rep["first_diff"]])
            ties.append((i, rep["first_diff"],
                         float(top[-1] - top[-2])))
    return ok


def _parity_word(ok, ties):
    return ("BROKEN" if not ok else
            f"near-tie ({len(ties)} streams)" if ties else "exact")


def clamp_to_waves(n, n_slots, label):
    """Round a flood width DOWN to a multiple of one admission wave
    (2 x n_slots). A ragged final half-wave measures slot-grid
    underfill, not the serving plane — the scale-measurement gotcha
    every flood phase used to dodge by hand-picked defaults is now
    enforced with a logged note instead of remembered."""
    wave = 2 * int(n_slots)
    clamped = max(wave, (int(n) // wave) * wave)
    if clamped != int(n):
        print(f"note: {label} {n} -> {clamped} (clamped to a multiple "
              f"of 2*n_slots={wave} so flood waves pack the slot grid "
              f"exactly)")
    return clamped


def run_continuous(net, prompts, n_tokens, *, n_slots, n_blocks,
                   block_len, steps_per_dispatch, quantize=None,
                   speculative=None, register_prefix=None,
                   spec_sampled=False, spec_draft_layers=None,
                   prefix_cache="registered", temperatures=None,
                   rng_seeds=None):
    """Event-driven client: submit every request, then await the
    streams' future faces. `prompts` is a LIST of 1-D arrays (lengths
    may differ — the mixed phase feeds heterogeneous lengths into one
    server). `speculative=k` turns on draft-accept decoding;
    `register_prefix=ids` warms a shared prefix before warmup (the
    CoW phase); `spec_sampled`/`spec_draft_layers`/`prefix_cache`
    ride straight into the server (the sampled-speculation, truncated-
    drafter and radix phases). `temperatures`/`rng_seeds` are optional
    PER-STREAM lists: temperature 0 rows stay greedy (bit-parity
    oracle), >0 rows sample under a pinned fold_in chain seeded from
    the matching rng_seeds entry. Returns
    (results list, ttft_ms, wall, server_stats)."""
    from deeplearning4j_tpu_torch.serving import GenerationServer
    n = len(prompts)
    server = GenerationServer(
        net, n_slots=n_slots, n_blocks=n_blocks, block_len=block_len,
        steps_per_dispatch=steps_per_dispatch, quantize=quantize,
        speculative=speculative, spec_sampled=spec_sampled,
        spec_draft_layers=spec_draft_layers, prefix_cache=prefix_cache,
        device=net.device)
    if register_prefix is not None:
        server.register_prefix(register_prefix)
    # run the (width x length-bucket) grid of the traffic's buckets
    # outside the timed window (the sequential baseline warms too)
    lens = [p.shape[0] for p in prompts]
    server.warmup((min(lens), max(lens)), n_tokens).start()

    # GC hygiene for the timed window: one gen2 sweep of a heap holding
    # the net costs the same order as a short window, and WHICH arm of
    # an A/B eats it is allocation-phase luck. Freeze the long-lived
    # heap so both arms pay only cheap nursery collections.
    gc.collect()
    gc.freeze()
    try:
        _common.sync(net.device)
        t0 = time.perf_counter()
        if temperatures is None:
            streams = [server.generate_async(p, n_tokens)
                       for p in prompts]
        else:
            streams = [server.generate_async(
                p, n_tokens, temperature=temperatures[i],
                rng=(np.asarray([0, rng_seeds[i]], np.uint32)
                     if temperatures[i] > 0 else None))
                for i, p in enumerate(prompts)]
        results, errors = [], []
        for i, s in enumerate(streams):
            try:
                results.append(
                    np.asarray(s.result(timeout=600), np.int64))
            except Exception as e:  # noqa: BLE001 — surfaced below
                results.append(None)
                errors.append((i, e))
        _common.sync(net.device)
        wall = time.perf_counter() - t0
    finally:
        gc.unfreeze()
    # TTFT from the PRODUCER timestamps the scheduler stamps on each
    # stream — no consumer thread needed to observe first tokens
    ttft_ms = np.asarray([(s.t_first - s.t_submit) * 1e3
                          if s.t_first is not None else np.nan
                          for s in streams])
    eng = server.engine
    stats = {
        "block_grants_total": eng.block_grants_total,
        "evict_requeue_total": eng.evict_requeue_total,
        "spec_dispatches": eng.spec_dispatches_total,
        "spec_accept_rate": (eng.spec_accepted_total
                             / max(1, eng.spec_proposed_total)),
        "spec_tokens_per_dispatch": (eng.spec_emitted_total
                                     / max(1, eng.spec_dispatches_total)),
        "prefix_hits": eng.prefix_hits_total,
        "prefix_tokens_saved": eng.prefix_tokens_saved_total,
        "prefix_forks": eng.prefix_forks_total,
        # per-proposer speculation split + the scheduler's arbitration
        # EWMAs (the truncated-drafter phase asserts on both)
        "spec_proposed_by": dict(eng.spec_proposed_by),
        "spec_accepted_by": dict(eng.spec_accepted_by),
        "spec_draft_dispatches": eng.spec_draft_dispatches_total,
        "spec_prop_ewma": dict(server._spec_prop_ewma),
        # radix prefix cache (zero everywhere in "registered" mode)
        "radix_nodes": (eng._radix.nodes if eng._radix is not None
                        else 0),
        "radix_hit_tokens": eng.radix_hit_tokens_total,
        "radix_evictions": eng.radix_evictions_total,
        # goodput ledger: every dispatched token-position classified
        # (conservation asserted downstream), plus per-stream TTFT
        # decomposition from the request traces when tracing is on
        "goodput": eng.goodput.snapshot(),
        "goodput_conserved": eng.goodput.conserved(),
    }
    from deeplearning4j_tpu_torch.monitor.goodput import ttft_decomposition
    parts = []
    for s in streams:
        tr = getattr(s, "trace", None)
        if tr is not None:
            dec = ttft_decomposition(tr)
            if dec is not None:
                parts.append(dec)
    stats["ttft_parts"] = parts
    server.stop()
    if errors:
        detail = "; ".join(f"stream {i}: {e!r}" for i, e in errors[:5])
        raise RuntimeError(
            f"{len(errors)}/{n} client streams failed — {detail}")
    return results, ttft_ms, wall, stats


def run_sequential(net, prompts, n_tokens, *, quantize=None):
    """The pre-serving baseline under the SAME event-driven harness:
    each request is one whole-batch B=1 `generate()` round-trip, one
    after another — a size-1 batch holds its full fixed-length cache
    for its whole lifetime and nobody shares a dispatch."""
    from deeplearning4j_tpu_torch.zoo.transformer import generate
    generate(net, prompts[0][None], n_tokens, temperature=0,
             quantize=quantize)                        # warm the jits
    gc.collect()                 # same GC hygiene as run_continuous
    gc.freeze()
    try:
        _common.sync(net.device)
        t0 = time.perf_counter()
        results = [generate(net, p[None], n_tokens, temperature=0,
                            quantize=quantize)[0]
                   for p in prompts]
        _common.sync(net.device)
        wall = time.perf_counter() - t0
    finally:
        gc.unfreeze()
    return results, wall


def reference_tokens(net, prompts, n_tokens, *, quantize=None):
    """Whole-batch `generate()` reference rows, batched per prompt
    length (mixed-length request sets group into same-length batches;
    greedy decode is batch-composition independent, so grouping does
    not change any row)."""
    from deeplearning4j_tpu_torch.zoo.transformer import generate
    out = [None] * len(prompts)
    by_len = {}
    for i, p in enumerate(prompts):
        by_len.setdefault(p.shape[0], []).append(i)
    for length, idxs in by_len.items():
        batch = np.stack([prompts[i] for i in idxs])
        toks = generate(net, batch, n_tokens, temperature=0,
                        quantize=quantize)
        for j, i in enumerate(idxs):
            out[i] = toks[j]
    return out


def concurrency_ab(net, prompt_len, n_tokens, *, n_slots, n_blocks,
                   block_len):
    """Incremental-vs-upfront admission concurrency at the SAME pool
    size: how many short-generation streams one burst admission takes.
    Upfront reserves every request's full budget; incremental grants
    the prompt footprint and grows lazily — the effective-concurrency
    lever (~budget/actual_length) the ROADMAP names."""
    from deeplearning4j_tpu_torch.serving import PagedDecodeEngine
    counts = {}
    for allocation in ("incremental", "upfront"):
        eng = PagedDecodeEngine(net, n_slots=n_slots, n_blocks=n_blocks,
                                block_len=block_len, allocation=allocation,
                                device=net.device)
        reqs = [dict(prompt_ids=np.zeros(prompt_len, np.int32),
                     n_tokens=n_tokens) for _ in range(n_slots)]
        counts[allocation] = len(eng.admit_many(reqs))
    return counts


def run_fleet(args, *, metrics_check=False):
    """Fleet phase: >10k concurrent streams across TWO registry-served
    models with a mid-run zero-downtime hot-swap and gauge-driven
    autoscaling.

    Timeline (all on the event-driven client — no per-stream thread):

    1. publish alpha v1 + beta v1 into a ModelRegistry, deploy both
       behind a FleetServer (full warmup grids), front with a
       FleetRouter;
    2. a probe burst against the deliberately-undersized beta backs its
       queue up; the FleetAutoscaler reads the per-model queue-depth /
       pool gauges and resizes beta through the swap machinery (same
       version — parity preserved across the resize);
    3. the main flood: `--fleet-streams` requests alternating
       alpha/beta, all outstanding at once (a sampler thread records
       peak simultaneously-open streams);
    4. MID-FLOOD, publish alpha v2 and swap in a background thread:
       the successor warms its full program grid while v1 still
       serves, the pointer flips, and post-flip admissions (submitted
       while the v1 incumbent is still draining its in-flight
       streams) measure the swap-window TTFT — warmed successor means
       no compile cliff;
    5. await every stream: ZERO drops, and every stream checks
       bit-equal against the reference of the version it was SERVED by
       (the version tag the router stamps).

    Returns (fleet_block, failures)."""
    import tempfile

    from deeplearning4j_tpu_torch.serving import (
        FleetAutoscaler,
        FleetRouter,
        FleetServer,
        ModelRegistry,
    )
    from deeplearning4j_tpu_torch.zoo.transformer import generate

    n_tok = args.fleet_tokens
    prompt_len = 6
    max_len = prompt_len + n_tok + 8
    max_len += (-max_len) % 8                     # block_len 8 divides
    mk = lambda seed: build_net(args.vocab, args.fleet_d_model, 1,
                                args.n_heads, max_len, seed=seed,
                                device=args.device)
    alpha_v1, alpha_v2, beta_v1 = mk(21), mk(22), mk(23)

    rng = np.random.default_rng(7)
    distinct = [rng.integers(0, args.vocab, prompt_len)
                for _ in range(16)]
    refs = {}
    for key, net in (("alpha", alpha_v1), ("alpha2", alpha_v2),
                     ("beta", beta_v1)):
        refs[key] = generate(net, np.stack(distinct), n_tok,
                             temperature=0)

    root = tempfile.mkdtemp(prefix="fleet-registry-")
    registry = ModelRegistry(root, keep_last=2)
    registry.publish("alpha", alpha_v1)
    registry.publish("beta", beta_v1)
    fleet = FleetServer(registry, device=args.device)
    router = FleetRouter(fleet)
    bps = -(-(prompt_len + n_tok) // 8)
    slots = args.n_slots
    t_deploy0 = time.perf_counter()
    fleet.deploy("alpha", n_slots=slots, n_blocks=slots * bps + 1,
                 block_len=8, steps_per_dispatch=args.steps_per_dispatch,
                 warmup_prompt_len=(prompt_len, prompt_len))
    # beta starts at HALF capacity — the autoscaler's job to fix
    beta_slots = max(2, slots // 2)
    fleet.deploy("beta", n_slots=beta_slots,
                 n_blocks=beta_slots * bps + 1, block_len=8,
                 steps_per_dispatch=args.steps_per_dispatch,
                 warmup_prompt_len=(prompt_len, prompt_len))
    deploy_s = time.perf_counter() - t_deploy0
    scaler = FleetAutoscaler(fleet, queue_depth_high=beta_slots * 2,
                             factor=2, max_slots=slots,
                             max_blocks=slots * bps + 1)

    failures = []
    streams = []          # (stream, model, ref_idx)

    def submit(model, i, n=n_tok):
        s = router.submit(model, distinct[i % 16], n)
        streams.append((s, model, i % 16))
        return s

    # ---- autoscale probe: back beta's queue up, let the gauges scale it
    probe = [submit("beta", i) for i in range(beta_slots * 4)]
    fleet.publish_gauges()
    decisions = scaler.check(["beta"])
    if not decisions:
        failures.append("autoscaler did not react to beta queue "
                        "pressure")
        autoscale = {"triggered": False}
    else:
        d = decisions[0]
        autoscale = {"triggered": True, "reason": d["reason"],
                     "before_slots": d["before"]["n_slots"],
                     "after_slots": d["after"]["n_slots"]}
        if d["after"]["n_slots"] <= d["before"]["n_slots"]:
            failures.append(f"autoscale did not grow beta: {d}")

    # ---- concurrency sampler (peak simultaneously-open streams)
    sustained = [0]
    sampling = [True]

    def sample():
        while sampling[0]:
            open_now = sum(1 for s, _, _ in streams
                           if not s._fut.done())
            if open_now > sustained[0]:
                sustained[0] = open_now
            time.sleep(0.005)

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()

    # ---- main flood across both models
    t0 = time.perf_counter()
    for i in range(args.fleet_streams):
        submit("alpha" if i % 2 == 0 else "beta", i)

    # ---- mid-flood hot-swap: publish v2, warm + flip in background
    registry.publish("alpha", alpha_v2)
    swap_info = {}
    swap_done = threading.Event()

    def do_swap():
        ts = time.perf_counter()
        try:
            swap_info["version"] = fleet.swap("alpha")
        except Exception as e:  # noqa: BLE001 — surfaced via failures
            swap_info["error"] = repr(e)
        swap_info["seconds"] = round(time.perf_counter() - ts, 3)
        swap_done.set()

    threading.Thread(target=do_swap, daemon=True).start()
    # wait for the POINTER FLIP (not the drain): post-flip admissions
    # go to the warmed v2 successor while v1 still decodes its backlog.
    # Production traffic keeps ARRIVING while the successor warms — a
    # steady trickle holds a floor of open alpha streams until the
    # flip, so the flip always lands mid-traffic (at smoke scale the
    # one-shot flood can drain faster than a full warmup grid
    # compiles; at full scale the flood itself outlasts the warmup and
    # the trickle submits little or nothing)
    trickle_floor, t_i = 32, 0
    while fleet.version("alpha") != 2 and not swap_done.is_set():
        open_alpha = sum(1 for s, m, _ in streams
                         if m == "alpha" and not s._fut.done())
        if open_alpha < trickle_floor:
            for _ in range(trickle_floor - open_alpha):
                submit("alpha", t_i)
                t_i += 1
        time.sleep(0.005)
    inflight_at_flip = sum(1 for s, m, _ in streams
                           if m == "alpha" and not s._fut.done())
    post_swap = [submit("alpha", i) for i in range(args.fleet_post_swap)]

    # ---- await everything: the zero-dropped-streams contract
    errors = 0
    for s, _, _ in streams:
        try:
            s.result(timeout=900)
        except Exception as e:  # noqa: BLE001 — counted, reported below
            errors += 1
            if errors <= 3:
                failures.append(f"fleet stream failed: {e!r}")
    _common.sync(args.device)
    wall = time.perf_counter() - t0
    sampling[0] = False
    sampler.join(timeout=5)
    swap_done.wait(timeout=900)
    if "error" in swap_info:
        failures.append(f"hot-swap failed: {swap_info['error']}")

    # ---- version-tagged parity: each stream vs the reference of the
    # version it was served by
    bad = 0
    for s, model, ri in streams:
        if s._fut.exception(timeout=0) is not None:
            continue
        key = model if getattr(s, "version", 1) == 1 else "alpha2"
        if not np.array_equal(np.asarray(s.result(timeout=0), np.int64),
                              np.asarray(refs[key][ri], np.int64)):
            bad += 1
    v1_alpha = sum(1 for s, m, _ in streams
                   if m == "alpha" and getattr(s, "version", 0) == 1)
    v2_alpha = sum(1 for s, m, _ in streams
                   if m == "alpha" and getattr(s, "version", 0) == 2)
    ttft = np.asarray([(s.t_first - s.t_submit) * 1e3
                       for s, _, _ in streams
                       if s.t_first is not None])
    # NB: streams[-0:] would be the WHOLE list — guard the empty case
    post_tail = streams[-len(post_swap):] if post_swap else []
    post_ttft = np.asarray([(s.t_first - s.t_submit) * 1e3
                            for s, _, _ in post_tail
                            if s.t_first is not None])
    swap_p50, swap_p99 = (np.percentile(post_ttft, [50, 99])
                          if post_ttft.size else (float("nan"),) * 2)
    total_emitted = sum(len(s.tokens) for s, _, _ in streams)

    fleet_block = {
        "models": 2,
        "streams_total": len(streams),
        "streams_sustained": int(sustained[0]),
        "n_tokens": n_tok,
        "tokens_emitted": int(total_emitted),
        "tokens_per_sec": round(total_emitted / wall, 2),
        "wall_seconds": round(wall, 3),
        "deploy_warmup_seconds": round(deploy_s, 3),
        "zero_dropped": errors == 0,
        "parity_version_tagged": "exact" if bad == 0 else
            f"BROKEN ({bad} streams)",
        "swap": {
            "from_version": 1, "to_version": swap_info.get("version"),
            "inflight_at_flip": int(inflight_at_flip),
            "alpha_streams_v1": v1_alpha, "alpha_streams_v2": v2_alpha,
            "seconds": swap_info.get("seconds"),
            "post_swap_streams": len(post_swap),
        },
        "swap_p50_ttft_ms": round(float(swap_p50), 1),
        "swap_p99_ttft_ms": round(float(swap_p99), 1),
        "p99_ttft_ms": round(float(np.percentile(ttft, 99)), 1)
            if ttft.size else None,
        "autoscale": autoscale,
    }

    # ---- hard asserts
    if errors:
        failures.append(f"{errors} fleet streams dropped/failed — the "
                        f"zero-dropped-streams contract is broken")
    if bad:
        failures.append(f"{bad} fleet streams broke version-tagged "
                        f"parity")
    if sustained[0] < args.fleet_min_sustained:
        failures.append(
            f"fleet sustained only {sustained[0]} concurrent streams "
            f"(< {args.fleet_min_sustained})")
    if inflight_at_flip < 1:
        failures.append("hot-swap was not mid-run: no alpha stream was "
                        "in flight at the pointer flip")
    if v2_alpha < 1:
        failures.append("no stream was served by alpha v2 post-swap")
    if post_ttft.size and swap_p99 > args.max_p99_ttft_s * 1e3:
        failures.append(
            f"post-swap p99 TTFT {swap_p99:.0f}ms exceeds the "
            f"{args.max_p99_ttft_s}s bound (compile cliff? the "
            f"successor must be warmed before the flip)")

    if metrics_check:
        # the [12/19] acceptance surface: the fleet/registry gauge
        # families must be live on /metrics
        import urllib.request

        from deeplearning4j_tpu_torch.ui import UIServer
        fleet.publish_gauges()
        ui = UIServer().start()
        try:
            body = urllib.request.urlopen(
                f"http://127.0.0.1:{ui.port}/metrics",
                timeout=10).read().decode()
            for fam in ("fleet_active_models", "fleet_queue_depth",
                        "fleet_model_version", "fleet_swaps_total",
                        "registry_published_total"):
                if fam not in body:
                    failures.append(f"{fam} missing from /metrics")
            page = urllib.request.urlopen(
                f"http://127.0.0.1:{ui.port}/serving",
                timeout=10).read().decode()
            if "alpha" not in page or "beta" not in page:
                failures.append("/serving page lacks per-model rows")
        finally:
            ui.stop()

    fleet.stop()
    import shutil
    shutil.rmtree(root, ignore_errors=True)
    return fleet_block, failures


def run_replicated(args):
    """Horizontal-serving phase: a multi-PROCESS replica fleet behind
    the elastic coordinator and the router's least-loaded balancing.

    Arms (matched floods, best-of-2 windows): A. ONE `spawn_replica`
    subprocess — flood S streams x T tokens through
    FleetRouter/ReplicaSet, greedy parity vs generate(); B. TWO
    subprocesses — the same flood. The aggregate tok/s of B over A is
    reported (`replica_scale_x`), not asserted: JAX's gate measures
    overlap against an emulated CPU dispatch floor the port's server
    does not have, and on one card both replicas share the device.

    Then the replica-death drill (hard SIGKILL of one replica
    mid-flood, once one of its streams has its first token: zero
    dropped accepted streams, migrated continuations bit-equal, router
    converges to the survivor set), the disaggregated prefill->decode
    parity check over DLFP frames, and the federation check
    (per-replica `serving_replica_*` gauges riding heartbeats into one
    aggregated snapshot).

    Returns (replicated_block, failures)."""
    import tempfile

    from deeplearning4j_tpu_torch.monitor.federate import (
        MetricsAggregator,
        ingest_elastic_status,
    )
    from deeplearning4j_tpu_torch.parallel.elastic import (
        ElasticCoordinator,
        retry_request,
    )
    from deeplearning4j_tpu_torch.serving import FleetRouter
    from deeplearning4j_tpu_torch.serving.disagg import (
        DecodeWorker,
        PrefillWorker,
        run_disaggregated,
    )
    from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
    from deeplearning4j_tpu_torch.serving.replica import (
        ReplicaSet,
        spawn_replica,
    )

    streams = args.replica_streams
    n_tok = 32
    prompt_len = 6
    block_len = 4
    n_slots = 8
    max_len = prompt_len + n_tok + block_len
    max_len += (-max_len) % block_len
    net = build_net(64, 16, 2, args.n_heads, max_len, seed=31,
                    device=args.device)

    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, 64, prompt_len) for _ in range(streams)]
    ref = reference_tokens(net, prompts, n_tok)

    root = tempfile.mkdtemp(prefix="replica-registry-")
    ModelRegistry(root).publish("m", net)
    coord = ElasticCoordinator(settle_s=0.2, grace_s=2.0).start()
    bps = -(-max_len // block_len)

    def spawn(token):
        t0 = time.perf_counter()
        proc = spawn_replica(
            root, "m", coordinator=coord.address, n_slots=n_slots,
            n_blocks=n_slots * bps + 1, block_len=block_len,
            steps_per_dispatch=4, warmup_prompt_len=prompt_len,
            token=token, device=args.device)
        return proc, round(time.perf_counter() - t0, 3)

    def flood(router, n_replicas, n=n_tok, ps=prompts):
        rset.refresh(force=True)
        deadline = time.monotonic() + 30
        while len(rset.backends()) < n_replicas \
                and time.monotonic() < deadline:
            time.sleep(0.05)
            rset.refresh(force=True)
        t0 = time.perf_counter()
        ss = [router.submit("m", p, n) for p in ps]
        outs = [s.result(300) for s in ss]
        return ss, outs, time.perf_counter() - t0

    failures = []
    r1, warm1_s = spawn("replica-1")
    rset = ReplicaSet(coord.address, "m", refresh_s=0.05)
    router = FleetRouter()
    router.attach_replicas("m", rset)

    # --------------------------------------------- arm A: one replica
    _, outs, wall_1r = min((flood(router, 1) for _ in range(2)),
                           key=lambda o: o[2])
    par_1r = all(np.array_equal(a, b) for a, b in zip(outs, ref))
    tps_1r = streams * n_tok / wall_1r

    # -------------------------------------------- arm B: two replicas
    r2, warm2_s = spawn("replica-2")
    ss, outs, wall_2r = min((flood(router, 2) for _ in range(2)),
                            key=lambda o: o[2])
    par_2r = all(np.array_equal(a, b) for a, b in zip(outs, ref))
    tps_2r = streams * n_tok / wall_2r
    used_2r = {s.replica for s in ss}
    scale = tps_2r / tps_1r

    # ---------------- federation: per-replica gauges on the heartbeat
    status = retry_request(coord.address, {"op": "status"})["status"]
    agg = MetricsAggregator()
    ingest_elastic_status(status, agg)
    fed = agg.snapshot()
    fed_fams = sorted(f for f in fed if f.startswith("serving_replica_"))
    fed_replicas = {e.get("labels", {}).get("replica")
                    for f in fed_fams for e in fed[f]["values"]}

    # ------------------------- drill: hard-kill a replica mid-flood
    drill_tok = 24
    drill_ref = reference_tokens(net, prompts, drill_tok)
    t0 = time.perf_counter()
    drill = [router.submit("m", p, drill_tok) for p in prompts]
    # the kill waits on an event, never on a sleep: the first stream
    # with its first token names the victim, whose other streams are
    # then in flight or queued (the flood holds two waves a replica)
    started = None
    deadline = time.monotonic() + 120
    while started is None and time.monotonic() < deadline:
        started = next((s for s in drill if s.t_first is not None
                        and s.replica is not None), None)
        time.sleep(0.002)
    victim = r2 if started is not None \
        and started.replica == "replica-2" else r1
    victim.kill()                                  # SIGKILL, no drain
    errors = 0
    completed = []
    for s in drill:
        try:
            completed.append(s.result(300))
        except Exception:  # noqa: BLE001 — counted, asserted below
            errors += 1
    drill_wall = time.perf_counter() - t0
    drill_par = (len(completed) == len(drill)
                 and all(np.array_equal(a, b)
                         for a, b in zip(completed, drill_ref)))
    migrated = sum(1 for s in drill if s.migrations > 0)
    survivor = "replica-1" if victim is r2 else "replica-2"
    deadline = time.monotonic() + 30
    toks = None
    while time.monotonic() < deadline:
        rset.refresh(force=True)
        toks = [t for t, _, _ in rset.backends()]
        if toks == [survivor]:
            break
        time.sleep(0.1)
    post = router.submit("m", prompts[0], n_tok)
    post_ok = (np.array_equal(post.result(60), ref[0])
               and post.replica == survivor)

    rset.close()
    for proc in (r1, r2):
        proc.stop()
    coord.stop()
    import shutil
    shutil.rmtree(root, ignore_errors=True)

    # -------------------- disaggregated prefill/decode (DLFP frames)
    pre = PrefillWorker(net, n_slots=n_slots, n_blocks=n_slots * bps,
                        block_len=block_len, device=net.device)
    dec = DecodeWorker(net, n_slots=n_slots,
                       n_blocks=n_slots * bps + 4, block_len=block_len,
                       device=net.device)
    disagg_out = run_disaggregated(pre, dec, prompts[:8], n_tok)
    disagg_par = all(np.array_equal(a, b)
                     for a, b in zip(disagg_out, ref[:8]))

    replicated_block = {
        "streams": streams,
        "n_tokens": n_tok,
        "step_floor_ms": None,
        "sandbox_model": (
            "no emulated dispatch floor: replica_scale_x is reported, "
            "not gated (on one card the replicas share the device)"),
        "tokens_per_sec_1r": round(tps_1r, 2),
        "tokens_per_sec_2r": round(tps_2r, 2),
        "replica_scale_x": round(scale, 3),
        "greedy_parity_1r": "exact" if par_1r else "BROKEN",
        "greedy_parity_2r": "exact" if par_2r else "BROKEN",
        "replicas_used_2r": len(used_2r),
        "warmup_seconds_r1": warm1_s,
        "warmup_seconds_r2": warm2_s,
        "federated_gauge_families": fed_fams,
        "federated_replicas": sorted(r for r in fed_replicas if r),
        "kill_drill": {
            "streams": len(drill),
            "completed": len(completed),
            "errors": errors,
            "migrated": migrated,
            "parity": "exact" if drill_par else "BROKEN",
            "wall_seconds": round(drill_wall, 3),
            "survivor_converged": toks == [survivor],
            "post_kill_submit_ok": post_ok,
        },
        "disagg": {
            "streams": 8,
            "parity_vs_colocated": "exact" if disagg_par else "BROKEN",
        },
    }

    # ---- hard asserts (the scale is reported, not asserted: see the
    # module docstring)
    if not par_1r or not par_2r:
        failures.append("replicated greedy streams diverge from "
                        "single-process generate()")
    if len(used_2r) < 2:
        failures.append("least-loaded balancing left one replica idle "
                        "through the whole 2-replica flood")
    if errors:
        failures.append(f"replica-death drill dropped {errors} "
                        f"accepted streams (contract: zero)")
    if not drill_par:
        failures.append("post-migration continuations broke greedy "
                        "parity")
    if migrated < 1:
        failures.append("the kill landed on an idle replica: no "
                        "stream actually migrated")
    if toks != [survivor]:
        failures.append(f"router never converged to the survivor set "
                        f"(saw {toks})")
    if not post_ok:
        failures.append("post-kill traffic did not land cleanly on "
                        "the survivor")
    if not disagg_par:
        failures.append("disaggregated prefill->decode handoff is not "
                        "bit-equal to the colocated greedy path")
    missing = {"serving_replica_queue_depth",
               "serving_replica_outstanding_tokens",
               "serving_replica_tok_s",
               "serving_replica_open_streams"} - set(fed_fams)
    if missing:
        failures.append(f"federated snapshot lacks per-replica gauge "
                        f"families: {sorted(missing)}")
    elif len(fed_replicas - {None}) < 2:
        failures.append("federation carried gauges for fewer than 2 "
                        "replicas")
    return replicated_block, failures


def train_cyclic_lm(args, *, d_model, n_tok, prompt_len, period=8,
                    epochs=None, seed=11):
    """Acceptance-friendly workload: a TransformerLM fit until its
    greedy continuation of a period-`period` token cycle reproduces
    the cycle exactly. This is the shape speculative decoding is FOR —
    a predictable target distribution (natural-language serving; a
    random-init LM's run-length noise is the adversarial case the
    accept-rate auto-disable handles). Training windows span the FULL
    position range: the sinusoidal positions the decode will visit
    must have been seen, or generation derails off-distribution.
    Returns (net, pattern, prompts, max_len); fails loudly if the
    model did not converge to the cycle (the phase would silently
    measure the wrong regime)."""
    max_len = prompt_len + n_tok + 8
    max_len += (-max_len) % 8
    net = build_net(args.vocab, d_model, args.n_layers, args.n_heads,
                    max_len, seed=seed, device=args.device)
    rng = np.random.default_rng(3)
    pattern = rng.choice(args.vocab, period, replace=False)
    corpus = np.tile(pattern, (128 + max_len) // period + 2)
    T = max_len - 1
    X = np.stack([corpus[i:i + T] for i in range(128)])
    Y = np.stack([corpus[i + 1:i + T + 1] for i in range(128)])
    net.fit(X.astype(np.float32),
            np.eye(args.vocab, dtype=np.float32)[Y],
            epochs=epochs, batch_size=32, shuffle=False)
    tiled = np.tile(pattern, (prompt_len // period) + 3)
    prompts = [tiled[i % period: i % period + prompt_len]
               for i in range(16)]
    from deeplearning4j_tpu_torch.zoo.transformer import generate
    ref = generate(net, np.stack(prompts), n_tok, temperature=0)
    clean = sum(bool((ref[i][period:] == ref[i][:-period]).all())
                for i in range(len(prompts)))
    if clean < len(prompts):
        raise RuntimeError(
            f"cyclic LM converged on only {clean}/{len(prompts)} "
            f"streams — the speculative phase needs a predictable "
            f"target (raise --spec-epochs)")
    return net, pattern, prompts, max_len


def run_speculative(args):
    """Phase 5: draft-accept speculative decoding A/B on the
    acceptance-friendly (trained-cyclic) workload. BOTH sides run the
    admit-every-dispatch schedule (steps_per_dispatch=1, the server
    default): the baseline pays one host dispatch per token, the
    speculative side amortizes it over every ACCEPTED draft — without
    giving up per-dispatch admission responsiveness the way J-chunking
    does (the J=16 chunked number rides along as reference). The win
    is host-dispatch amortization (the decode is host bound on the card
    too), plus one weight read per k scored tokens instead of k."""
    n_tok = args.spec_tokens
    net, pattern, base_prompts, max_len = train_cyclic_lm(
        args, d_model=args.d_model, n_tok=n_tok,
        prompt_len=args.spec_prompt_len, epochs=args.spec_epochs)
    prompts = [base_prompts[i % 16] for i in range(args.streams)]
    refs = reference_tokens(net, prompts, n_tok)
    bps = -(-(args.spec_prompt_len + n_tok) // args.block_len)
    pool = dict(n_slots=args.n_slots,
                n_blocks=args.n_slots * bps + 1,
                block_len=args.block_len)
    # the timed windows are short and swing with the host's scheduling,
    # so (timeit-style) each asserted arm takes the best of two
    # windows; parity is checked on every run's tokens, not just the
    # fastest
    def best_of(n_runs, **kw):
        best = None
        for _ in range(n_runs):
            out = run_continuous(net, prompts, n_tok, **kw)
            if not all(np.array_equal(a, b)
                       for a, b in zip(refs, out[0])):
                return out   # parity break — surface it downstream
            if best is None or out[2] < best[2]:
                best = out
        return best

    for _attempt in range(2):
        base, _, base_wall, _ = best_of(2, steps_per_dispatch=1, **pool)
        spec, _, spec_wall, sstats = best_of(
            3, steps_per_dispatch=1, speculative=args.spec_k, **pool)
        if base_wall >= 2.0 * spec_wall:
            break       # bar met — otherwise one retry with fresh
            # windows (host contention can depress several consecutive
            # windows at once)
    chunk, _, chunk_wall, _ = run_continuous(
        net, prompts, n_tok,
        steps_per_dispatch=args.steps_per_dispatch, **pool)
    total = len(prompts) * n_tok
    base_tps, spec_tps = total / base_wall, total / spec_wall
    parity = (all(np.array_equal(a, b) for a, b in zip(refs, base))
              and all(np.array_equal(a, b) for a, b in zip(refs, spec))
              and all(np.array_equal(a, b) for a, b in zip(refs, chunk)))
    block = {
        "tokens_per_sec": round(spec_tps, 2),
        "baseline_tokens_per_sec": round(base_tps, 2),
        "baseline_chunked_tokens_per_sec":
            round(total / chunk_wall, 2),
        "chunked_steps_per_dispatch": args.steps_per_dispatch,
        "speedup_vs_baseline": round(spec_tps / base_tps, 3),
        "spec_k": args.spec_k,
        "accept_rate": round(sstats["spec_accept_rate"], 4),
        "tokens_per_dispatch":
            round(sstats["spec_tokens_per_dispatch"], 1),
        "greedy_parity": "exact" if parity else "BROKEN",
        "workload": f"trained cyclic LM (period {len(pattern)}), "
                    f"{len(prompts)} streams x {n_tok} tokens",
        "note": "A/B at matched steps_per_dispatch=1 scheduling; the "
                "win is host-dispatch amortization plus one weight "
                "read per k scored tokens",
    }
    failures = []
    if not parity:
        failures.append("speculative phase broke greedy parity")
    if sstats["spec_accept_rate"] <= 0:
        failures.append("speculative phase accepted nothing — the "
                        "proposer never drafted on a cyclic stream")
    if spec_tps < 2.0 * base_tps:
        failures.append(
            f"speculative decode {spec_tps:.0f} tok/s is below 2x the "
            f"non-speculative baseline {base_tps:.0f} (the acceptance "
            f"bar) on the acceptance-friendly workload")
    return block, failures, net, max_len


def run_shared_prefix(args, net, max_len):
    """Phase 6: copy-on-write shared-prefix block reuse A/B. Every
    stream's prompt = one registered prefix + a short distinct tail;
    the shared server prefills the prefix ONCE and maps it CoW per
    admission. The structural metric is the prefill-token reduction
    (total prompt tokens / tokens actually prefilled) — a silent
    fall-back to private blocks reports ~1.0 and gates."""
    n_tok = args.spec_tokens
    rng = np.random.default_rng(17)
    # one short of the prompt length: a prefix ending MID-BLOCK, so
    # every admission exercises the copy-on-first-write tail fork in
    # the committed ledger (an aligned prefix shares without forking)
    prefix_len = args.spec_prompt_len - 1
    tail = 4
    prefix = rng.integers(0, args.vocab, prefix_len)
    prompts = [np.concatenate([prefix, rng.integers(0, args.vocab, tail)])
               for _ in range(args.streams)]
    refs = reference_tokens(net, prompts, n_tok)
    bps = -(-(prefix_len + tail + n_tok) // args.block_len)
    pool = dict(n_slots=args.n_slots,
                n_blocks=args.n_slots * bps
                + -(-prefix_len // args.block_len) + 1,
                block_len=args.block_len,
                steps_per_dispatch=args.steps_per_dispatch)
    private, p_ttft, _, _ = run_continuous(net, prompts, n_tok, **pool)
    shared, s_ttft, _, stats = run_continuous(
        net, prompts, n_tok, register_prefix=prefix, **pool)
    parity_ref = all(np.array_equal(a, b) for a, b in zip(refs, shared))
    parity_private = all(np.array_equal(a, b)
                         for a, b in zip(private, shared))
    total_prompt = sum(p.shape[0] for p in prompts)
    prefilled = total_prompt - stats["prefix_tokens_saved"]
    reduction = total_prompt / max(1, prefilled)
    block = {
        "streams": len(prompts),
        "prefix_len": prefix_len,
        "tail_len": tail,
        "prefix_hits": stats["prefix_hits"],
        "prefix_tokens_saved": stats["prefix_tokens_saved"],
        "prefix_forks": stats["prefix_forks"],
        "prefill_reduction": round(reduction, 3),
        "p50_ttft_private_ms":
            round(float(np.nanpercentile(p_ttft, 50)), 2),
        "p50_ttft_shared_ms":
            round(float(np.nanpercentile(s_ttft, 50)), 2),
        "parity_vs_generate": "exact" if parity_ref else "BROKEN",
        "parity_vs_private_blocks":
            "exact" if parity_private else "BROKEN",
    }
    failures = []
    if not parity_ref:
        failures.append("shared-prefix streams diverge from "
                        "whole-batch generate()")
    if not parity_private:
        failures.append("shared-prefix streams diverge from "
                        "private-block streams")
    if stats["prefix_hits"] < len(prompts):
        failures.append(
            f"only {stats['prefix_hits']}/{len(prompts)} admissions "
            f"hit the registered prefix")
    if reduction < 2.0:
        failures.append(
            f"prefix prefill reduction {reduction:.2f}x below the 2x "
            f"floor (sharing silently disabled?)")
    if prefix_len % args.block_len != 0 and stats["prefix_forks"] < 1:
        failures.append("mid-block prefix tail never forked — the "
                        "copy-on-first-write path did not run")
    return block, failures


def _chi2_crit(df, q=0.9999):
    """Upper chi-square quantile: scipy when present, Wilson-Hilferty
    otherwise (~1% accurate here; callers add a +5% margin)."""
    try:
        from scipy.stats import chi2
        return float(chi2.ppf(q, df))
    except Exception:  # noqa: BLE001 — scipy is optional
        z = 3.719      # standard normal quantile at 1 - 1e-4
        a = 2.0 / (9.0 * df)
        return df * (1.0 - a + z * np.sqrt(a)) ** 3


def _chi2_two_sample(tokens_a, tokens_b, vocab):
    """2xk homogeneity statistic between two equal-size token draws
    (tail cells lumped below 10 total); returns (stat, df, crit)."""
    c1 = np.bincount(tokens_a, minlength=vocab).astype(float)
    c2 = np.bincount(tokens_b, minlength=vocab).astype(float)
    tot = c1 + c2
    big = tot >= 10.0
    c1 = np.append(c1[big], c1[~big].sum())
    c2 = np.append(c2[big], c2[~big].sum())
    tot = c1 + c2
    keep = tot > 0
    exp = tot[keep] / 2.0
    stat = float((((c1[keep] - exp) ** 2 / exp).sum()
                  + ((c2[keep] - exp) ** 2 / exp).sum()))
    df = int(keep.sum()) - 1
    return stat, df, _chi2_crit(max(1, df))


def run_sampled_spec(args):
    """Phase 7: REJECTION-SAMPLED speculation A/B on the trained-cyclic
    workload — the lever that extends the PR-14 greedy-only speedup to
    sampled traffic. Both arms run steps_per_dispatch=1 with the SAME
    per-stream temperatures and pinned rng seeds: the baseline is the
    vanilla sampled server (speculative off — one dispatch per token),
    the treatment turns on `speculative=k, spec_sampled=True`. A
    greedy subset rides in the same wave and must stay bit-equal to
    whole-batch generate() (the argmax oracle is untouched by the
    rejection path). The distributional contract — each emitted token
    is marginally a vanilla sample from the filtered/tempered target —
    is held by a dedicated two-sample chi-square over first-token
    marginals: many single-shot streams per arm from ONE prompt are
    iid draws from the same conditional, so homogeneity at the
    q = 1 - 1e-4 critical value is a sound end-to-end parity check
    (the per-case goodness-of-fit lives in
    tests/test_serving_statistical.py)."""
    n_tok = args.spec_tokens
    net, pattern, base_prompts, max_len = train_cyclic_lm(
        args, d_model=args.d_model, n_tok=n_tok,
        prompt_len=args.spec_prompt_len, epochs=args.spec_epochs)
    prompts = [base_prompts[i % 16] for i in range(args.streams)]
    n_greedy = min(8, len(prompts))
    # low sampling temperature keeps the trained cycle the modal
    # continuation, so the n-gram proposer's drafts still carry real
    # q_t mass — the regime sampled speculation is FOR (temperature ~1
    # on a near-deterministic target is the low-acceptance edge the
    # EWMA latch handles)
    temps = [0.0] * n_greedy + [0.25] * (len(prompts) - n_greedy)
    seeds = [1000 + i for i in range(len(prompts))]
    refs = reference_tokens(net, prompts[:n_greedy], n_tok)
    bps = -(-(args.spec_prompt_len + n_tok) // args.block_len)
    pool = dict(n_slots=args.n_slots,
                n_blocks=args.n_slots * bps + 1,
                block_len=args.block_len)

    def best_of(n_runs, **kw):
        best = None
        for _ in range(n_runs):
            out = run_continuous(net, prompts, n_tok,
                                 temperatures=temps, rng_seeds=seeds,
                                 **kw)
            if not all(np.array_equal(a, b)
                       for a, b in zip(refs, out[0][:n_greedy])):
                return out   # greedy-subset parity break — surface it
            if best is None or out[2] < best[2]:
                best = out
        return best

    for _attempt in range(2):
        base, _, base_wall, bstats = best_of(
            2, steps_per_dispatch=1, **pool)
        spec, _, spec_wall, sstats = best_of(
            3, steps_per_dispatch=1, speculative=args.spec_k,
            spec_sampled=True, **pool)
        if base_wall >= 1.3 * spec_wall:
            break       # bar met — otherwise one retry with fresh
            # windows (host contention, as in phase 5)
    total = len(prompts) * n_tok
    base_tps, spec_tps = total / base_wall, total / spec_wall
    parity = (all(np.array_equal(a, b)
                  for a, b in zip(refs, base[:n_greedy]))
              and all(np.array_equal(a, b)
                      for a, b in zip(refs, spec[:n_greedy])))
    in_vocab = all(
        len(r) == n_tok and all(0 <= t < args.vocab for t in r)
        for r in spec[n_greedy:])

    # ------ distributional parity: two-sample over the FIRST DECODE
    # token (index 1 — index 0 comes from the prefill's sampling tail,
    # which speculation never touches; the first decode dispatch is
    # where drafts land and rejection runs). Streams share one prompt
    # with per-stream keys, so index-1 tokens are iid draws from the
    # same two-step conditional in both arms.
    n_par = 256
    par_prompts = [base_prompts[0]] * n_par
    par_temps = [0.9] * n_par

    def decode_tokens(seed0, **kw):
        out = run_continuous(
            net, par_prompts, 3, temperatures=par_temps,
            rng_seeds=[seed0 + i for i in range(n_par)],
            steps_per_dispatch=1, **pool, **kw)
        return (np.asarray([int(r[1]) for r in out[0]]), out[3])

    van_first, _ = decode_tokens(2000)
    rs_first, rs_stats = decode_tokens(
        6000, speculative=args.spec_k, spec_sampled=True)
    stat, df, crit = _chi2_two_sample(van_first, rs_first, args.vocab)
    chi_ok = stat < 1.05 * crit

    block = {
        "tokens_per_sec": round(spec_tps, 2),
        "baseline_tokens_per_sec": round(base_tps, 2),
        "speedup_vs_baseline": round(spec_tps / base_tps, 3),
        "spec_k": args.spec_k,
        "temperature": 0.25,
        "accept_rate": round(sstats["spec_accept_rate"], 4),
        "tokens_per_dispatch":
            round(sstats["spec_tokens_per_dispatch"], 1),
        "greedy_subset_parity": "exact" if parity else "BROKEN",
        "chi_square": {"stat": round(stat, 2), "df": df,
                       "crit_1e-4": round(crit, 2),
                       "samples_per_arm": n_par,
                       "status": "pass" if chi_ok else "FAIL"},
        "workload": f"trained cyclic LM (period {len(pattern)}), "
                    f"{len(prompts)} streams x {n_tok} tokens "
                    f"({n_greedy} greedy + sampled T=0.25)",
        "note": "A/B at matched steps_per_dispatch=1; baseline is the "
                "vanilla sampled server (depth-1 dispatches), the "
                "treatment accepts drafts with prob min(1, q_t(d)) "
                "and resamples the normalized residual on rejection",
    }
    failures = []
    if not parity:
        failures.append("sampled-spec phase broke greedy-subset parity")
    if not in_vocab:
        failures.append("sampled streams emitted wrong-length or "
                        "out-of-vocab tokens under spec_sampled")
    if sstats["spec_accept_rate"] <= 0:
        failures.append("sampled speculation accepted nothing on the "
                        "acceptance-friendly workload")
    if rs_stats["spec_proposed_by"]["ngram"] <= 0:
        failures.append("chi-square arm never drafted — the parity "
                        "check did not exercise the rejection path")
    if not (bstats["goodput_conserved"]
            and sstats["goodput_conserved"]
            and rs_stats["goodput_conserved"]):
        failures.append("goodput ledger broke conservation in a "
                        "sampled-spec arm")
    if spec_tps < 1.3 * base_tps:
        failures.append(
            f"sampled speculation {spec_tps:.0f} tok/s is below 1.3x "
            f"the vanilla sampled baseline {base_tps:.0f} (the "
            f"acceptance bar) at matched steps_per_dispatch=1")
    if not chi_ok:
        failures.append(
            f"first-token marginals distinguishable between arms: "
            f"chi2={stat:.1f} over df={df} exceeds the 1e-4 critical "
            f"value {crit:.1f} — the rejection sampler has drifted "
            f"from the vanilla target distribution")
    return block, failures, net, max_len


def train_counting_lm(args, *, d_model, n_tok, prompt_len, epochs,
                      seed=23):
    """Adversarial-for-n-gram but PREDICTABLE workload: an LM fit
    until its greedy continuation of the ascending token sequence
    (next = cur + 1 mod vocab) is exact. Within any served window
    (prompt + generation << vocab) no suffix token ever RECURS, so
    the n-gram proposer is structurally starved — there is no earlier
    occurrence to match — while the model itself is maximally
    predictable. This is the regime the truncated-layer drafter is
    FOR: predictable target, nothing for prompt-lookup to find.
    Returns (net, prompts, max_len); fails loudly on non-convergence
    (the phase would otherwise measure a noise model)."""
    max_len = prompt_len + n_tok + 8
    max_len += (-max_len) % 8
    net = build_net(args.vocab, d_model, args.n_layers, args.n_heads,
                    max_len, seed=seed, device=args.device)
    corpus = np.arange(128 + max_len + 1) % args.vocab
    T = max_len - 1
    X = np.stack([corpus[i:i + T] for i in range(128)])
    Y = np.stack([corpus[i + 1:i + T + 1] for i in range(128)])
    # offsets spaced so stream windows stay wrap-free and distinct
    prompts = [np.arange(i, i + prompt_len) % args.vocab
               for i in range(16)]
    from deeplearning4j_tpu_torch.zoo.transformer import generate
    # next = cur + 1 over a 101-token vocab is a harder map than the
    # period-8 cycle (the whole permutation must land in the head) —
    # train in rounds until every stream's greedy continuation counts
    clean = 0
    for _round in range(4):
        net.fit(X.astype(np.float32),
                np.eye(args.vocab, dtype=np.float32)[Y],
                epochs=epochs, batch_size=32, shuffle=False)
        ref = generate(net, np.stack(prompts), n_tok, temperature=0)
        clean = sum(
            bool((np.asarray(ref[i])
                  == (np.arange(i + prompt_len, i + prompt_len + n_tok)
                      % args.vocab)).all())
            for i in range(len(prompts)))
        if clean == len(prompts):
            break
    if clean < len(prompts):
        raise RuntimeError(
            f"counting LM converged on only {clean}/{len(prompts)} "
            f"streams — the truncated-drafter phase needs a "
            f"predictable target (raise --spec-epochs)")
    return net, prompts, max_len


def run_truncated_drafter(args):
    """Phase 8: truncated-layer drafter on the ADVERSARIAL-for-n-gram
    workload — ascending-counter streams whose suffix tokens never
    recur inside a served window, so the prompt-lookup proposer is
    structurally starved (no earlier occurrence to match; the
    acceptance-EWMA arbitration's auto-disable regime) while the
    target stays maximally predictable. The first-L/2-blocks draft
    pass (same weights, no second model) keeps proposing through it:
    the assert is a truncated accept_rate > 0 with the n-gram
    proposer starved or collapsed, and greedy parity bit-exact
    throughout — the verify dispatch's argmax stays the oracle no
    matter what the half-depth model drafts."""
    n_tok = args.spec_tokens
    prompt_len = args.spec_prompt_len
    net, base_prompts, max_len = train_counting_lm(
        args, d_model=args.d_model, n_tok=n_tok,
        prompt_len=prompt_len, epochs=args.spec_epochs)
    n_streams = min(32, args.streams)
    prompts = [base_prompts[i % 16] for i in range(n_streams)]
    refs = reference_tokens(net, prompts, n_tok)
    bps = -(-(prompt_len + n_tok) // args.block_len)
    pool = dict(n_slots=args.n_slots,
                n_blocks=args.n_slots * bps + 1,
                block_len=args.block_len)
    draft_layers = max(1, args.n_layers // 2)
    out, _, wall, stats = run_continuous(
        net, prompts, n_tok, steps_per_dispatch=1,
        speculative=args.spec_k, spec_draft_layers=draft_layers,
        **pool)
    parity = all(np.array_equal(a, b) for a, b in zip(refs, out))
    tr_prop = stats["spec_proposed_by"]["truncated"]
    tr_acc = stats["spec_accepted_by"]["truncated"]
    ng_ewma = stats["spec_prop_ewma"]["ngram"]
    block = {
        "streams": n_streams,
        "draft_layers": draft_layers,
        "model_layers": args.n_layers,
        "tokens_per_sec": round(n_streams * n_tok / wall, 2),
        "truncated_proposed": tr_prop,
        "truncated_accepted": tr_acc,
        "truncated_accept_rate": round(tr_acc / max(1, tr_prop), 4),
        "draft_dispatches": stats["spec_draft_dispatches"],
        "ngram_accept_ewma":
            None if ng_ewma is None else round(ng_ewma, 4),
        "greedy_parity": "exact" if parity else "BROKEN",
        "ngram_proposed": stats["spec_proposed_by"]["ngram"],
        "workload": f"trained counting LM, {n_streams} "
                    f"ascending-offset streams x {n_tok} tokens (no "
                    f"suffix recurrence: the n-gram-starved regime)",
        "note": "no second model: the drafter is the first "
                f"{draft_layers}/{args.n_layers} blocks of the serving "
                "weights; its K/V lands in the slot's own uncommitted "
                "write window and the verify dispatch rewrites it",
    }
    failures = []
    if not parity:
        failures.append("truncated-drafter phase broke greedy parity")
    if tr_prop <= 0 or stats["spec_draft_dispatches"] <= 0:
        failures.append("truncated drafter never proposed — the draft "
                        "program did not run")
    if tr_acc <= 0:
        failures.append(
            "truncated drafter accept_rate is 0 on the non-repetitive "
            "workload — the half-depth pass drafts nothing the full "
            "model agrees with")
    if ng_ewma is not None and ng_ewma >= 0.3:
        failures.append(
            f"n-gram EWMA {ng_ewma:.2f} stayed above the 0.3 floor — "
            f"the workload was not adversarial for the n-gram "
            f"proposer, so the phase proves nothing about arbitration")
    if not stats["goodput_conserved"]:
        failures.append("goodput ledger broke conservation with the "
                        "truncated drafter (draft-lane accounting)")
    return block, failures


def run_radix(args, net, max_len):
    """Phase 9: radix prefix cache A/B — the same shared-prefix
    traffic as phase 6 but with ZERO `register_prefix` calls: the
    admission path itself matches/inserts block-aligned chunks in the
    radix tree, so mid-prompt overlap dedups automatically. The
    structural metric is again the prefill-token reduction; a second,
    deliberately pool-starved run proves LRU eviction of unpinned
    radix nodes actually fires under pressure (radix-held blocks are
    reclaimable, not leaked capacity)."""
    n_tok = args.spec_tokens
    rng = np.random.default_rng(31)
    # block-ALIGNED shared prefix: every admission's match ends on a
    # block boundary and the tails diverge — pure automatic dedup (the
    # mid-block CoW fork stays phase 6's registered-prefix territory)
    prefix_len = args.spec_prompt_len - (args.spec_prompt_len
                                         % args.block_len)
    tail = 4
    prefix = rng.integers(0, args.vocab, prefix_len)
    prompts = [np.concatenate([prefix,
                               rng.integers(0, args.vocab, tail)])
               for _ in range(args.streams)]
    refs = reference_tokens(net, prompts, n_tok)
    bps = -(-(prefix_len + tail + n_tok) // args.block_len)
    pool = dict(n_slots=args.n_slots,
                n_blocks=args.n_slots * bps
                + -(-prefix_len // args.block_len) + 1,
                block_len=args.block_len,
                steps_per_dispatch=args.steps_per_dispatch)
    private, _, _, _ = run_continuous(net, prompts, n_tok, **pool)
    shared, _, _, stats = run_continuous(
        net, prompts, n_tok, prefix_cache="radix", **pool)
    parity_ref = all(np.array_equal(a, b)
                     for a, b in zip(refs, shared))
    parity_private = all(np.array_equal(a, b)
                         for a, b in zip(private, shared))
    total_prompt = sum(p.shape[0] for p in prompts)
    prefilled = total_prompt - stats["prefix_tokens_saved"]
    reduction = total_prompt / max(1, prefilled)

    # ---- eviction under pressure: distinct prompts into a pool sized
    # so retired streams' radix-held blocks MUST be reclaimed for the
    # next admissions to land
    ev_prompts = [rng.integers(0, args.vocab, prefix_len + tail)
                  for _ in range(4 * args.n_slots)]
    _, _, _, ev_stats = run_continuous(
        net, ev_prompts, n_tok, prefix_cache="radix",
        n_slots=args.n_slots, n_blocks=args.n_slots * bps + 1,
        block_len=args.block_len,
        steps_per_dispatch=args.steps_per_dispatch)

    block = {
        "streams": len(prompts),
        "prefix_len": prefix_len,
        "tail_len": tail,
        "radix_hits": stats["prefix_hits"],
        "radix_hit_tokens": stats["radix_hit_tokens"],
        "radix_nodes": stats["radix_nodes"],
        "prefill_reduction": round(reduction, 3),
        "register_prefix_calls": 0,
        "evictions_under_pressure": ev_stats["radix_evictions"],
        "parity_vs_generate": "exact" if parity_ref else "BROKEN",
        "parity_vs_private_blocks":
            "exact" if parity_private else "BROKEN",
    }
    failures = []
    if not parity_ref:
        failures.append("radix-dedup streams diverge from whole-batch "
                        "generate()")
    if not parity_private:
        failures.append("radix-dedup streams diverge from "
                        "private-block streams")
    if stats["prefix_hits"] < len(prompts) - args.n_slots:
        failures.append(
            f"only {stats['prefix_hits']}/{len(prompts)} admissions "
            f"hit the radix tree (first-wave misses excepted)")
    if stats["radix_hit_tokens"] != stats["prefix_tokens_saved"]:
        failures.append("radix hit-token counter disagrees with the "
                        "prefill-savings ledger")
    if reduction < 2.0:
        failures.append(
            f"radix prefill reduction {reduction:.2f}x below the 2x "
            f"floor with zero register_prefix calls (auto-dedup "
            f"silently disabled?)")
    if ev_stats["radix_evictions"] < 1:
        failures.append("pool-starved radix run never evicted — "
                        "radix-held blocks are leaking pool capacity")
    if not (stats["goodput_conserved"]
            and ev_stats["goodput_conserved"]):
        failures.append("goodput ledger broke conservation in a radix "
                        "phase")
    return block, failures


def goodput_block(stats):
    """`extras.goodput`: one server's token-position ledger as a BENCH
    block.  `goodput_fraction` is the structurally-gated number
    (bench.GATE_TOLERANCES — a silently-broken accounting path reports
    ~0 or ~1.0 and gates); the waste split and the TTFT decomposition
    ride along as diagnosis."""
    from deeplearning4j_tpu_torch.monitor.goodput import GOODPUT_CLASSES
    gp = stats["goodput"]
    total = max(1, gp["dispatched_total"])
    block = {
        "dispatched_token_positions": gp["dispatched_total"],
        "goodput_fraction": round(gp["goodput_fraction"], 4),
        "conserved": bool(stats["goodput_conserved"]),
        "class_fractions": {c: round(gp[c] / total, 4)
                            for c in GOODPUT_CLASSES},
    }
    parts = stats.get("ttft_parts") or []
    if parts:
        dec = {}
        for key in ("queue_wait_s", "prefill_s", "first_emit_s"):
            vals = np.asarray([p[key] for p in parts]) * 1e3
            p50, p99 = np.percentile(vals, [50, 99])
            dec[f"{key[:-2]}_p50_ms"] = round(float(p50), 3)
            dec[f"{key[:-2]}_p99_ms"] = round(float(p99), 3)
        block["ttft_decomposition_ms"] = dec
        block["ttft_traced_streams"] = len(parts)
    return block


def run_overload(net, prompts, n_tokens, *, block_len):
    """Deliberate overload: a 1-slot, minimum-pool server with a tiny
    queue cap + SLO takes a burst it cannot possibly serve — the
    admission policy must shed rather than queue into certain
    lateness."""
    from deeplearning4j_tpu_torch.serving import GenerationServer, ShedError
    nb = -(-(prompts[0].shape[0] + n_tokens) // block_len) + 1
    server = GenerationServer(net, n_slots=1, n_blocks=nb,
                              block_len=block_len, max_queue=2,
                              slo_ttft_s=1e-3, device=net.device).start()
    streams = [server.generate_async(prompts[i % len(prompts)], n_tokens)
               for i in range(16)]
    shed = served = 0
    for s in streams:
        try:
            s.result(timeout=600)
            served += 1
        except ShedError:
            shed += 1
    server.stop()
    return shed, served


def _gates_not_ported(metrics):
    """The `compare_bench` self-gates of JAX's smokes need the port's
    benchmark harness (`bench.py`), which is not ported yet."""
    print(f"compare_bench self-gates ({metrics}): not yet ported (they "
          f"wait for the port's bench.py)")


def run_spec_smoke(args):
    """`--spec-smoke`: the speculative + shared-prefix phases alone
    (hard asserts inside each) and the serving_spec_*/serving_prefix_*
    families live on /metrics. JAX's `compare_bench` self-gates wait for
    the port's bench.py (`_gates_not_ported`)."""
    import urllib.request

    from deeplearning4j_tpu_torch.ui import UIServer

    spec_block, failures, net, max_len = run_speculative(args)
    prefix_block, f2 = run_shared_prefix(args, net, max_len)
    failures.extend(f2)
    rec = {"platform": _common.card_label(args.device), "value": 1.0,
           "extras": {"serving_speculative": spec_block,
                      "serving_prefix": prefix_block}}
    print(json.dumps(rec["extras"], indent=2, sort_keys=True))
    _gates_not_ported("serving_prefix_prefill_reduction, "
                      "serving_speculative_tokens_per_sec")
    # the gauge families the scheduler publishes must be live
    ui = UIServer().start()
    try:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{ui.port}/metrics", timeout=10
        ).read().decode()
        for fam in ("serving_spec_accept_rate",
                    "serving_spec_tokens_per_dispatch",
                    "serving_prefix_blocks_shared",
                    "serving_prefix_hits_total"):
            if fam not in body:
                failures.append(f"{fam} missing from /metrics")
    finally:
        ui.stop()
    if failures:
        for f_ in failures:
            print(f"FAIL: {f_}", file=sys.stderr)
        return 1
    print(f"spec+CoW smoke OK (speculative "
          f"{spec_block['speedup_vs_baseline']}x at accept "
          f"{spec_block['accept_rate']}, prefill reduction "
          f"{prefix_block['prefill_reduction']}x over "
          f"{prefix_block['streams']} shared-prefix streams, parity "
          f"exact, gates live)")
    return 0


def run_sampled_spec_smoke(args):
    """`--sampled-spec-smoke`: the sampled-speculation + truncated-drafter
    + radix phases alone (hard asserts inside each — chi-square parity
    at the 1e-4 critical value, >=1.3x sampled-spec throughput at
    matched steps_per_dispatch, >=2x radix prefill reduction with ZERO
    register_prefix calls, eviction under pool pressure, truncated
    accept > 0 where the n-gram EWMA collapses, greedy parity
    everywhere), and the serving_radix_* / per-proposer
    serving_spec_* families live on /metrics. JAX's `compare_bench`
    self-gates wait for the port's bench.py (`_gates_not_ported`)."""
    import urllib.request

    from deeplearning4j_tpu_torch.ui import UIServer

    sampled_block, failures, net, max_len = run_sampled_spec(args)
    trunc_block, f2 = run_truncated_drafter(args)
    radix_block, f3 = run_radix(args, net, max_len)
    failures.extend(f2)
    failures.extend(f3)
    rec = {"platform": _common.card_label(args.device), "value": 1.0,
           "extras": {"serving_sampled_spec": sampled_block,
                      "serving_truncated_draft": trunc_block,
                      "serving_radix": radix_block}}
    print(json.dumps(rec["extras"], indent=2, sort_keys=True))
    _gates_not_ported("serving_sampled_spec_tokens_per_sec, "
                      "serving_radix_prefill_reduction, "
                      "serving_truncated_draft_truncated_accept_rate")
    # the radix + per-proposer gauge families must be live
    ui = UIServer().start()
    try:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{ui.port}/metrics", timeout=10
        ).read().decode()
        for fam in ("serving_radix_nodes",
                    "serving_radix_hit_tokens_total",
                    "serving_radix_evictions_total",
                    "serving_spec_accept_rate"):
            if fam not in body:
                failures.append(f"{fam} missing from /metrics")
        for lbl in ('proposer="ngram"', 'proposer="truncated"'):
            if lbl not in body:
                failures.append(f"per-proposer label {lbl} missing "
                                f"from /metrics")
    finally:
        ui.stop()
    if failures:
        for f_ in failures:
            print(f"FAIL: {f_}", file=sys.stderr)
        return 1
    print(f"sampled-spec smoke OK (sampled speculation "
          f"{sampled_block['speedup_vs_baseline']}x at accept "
          f"{sampled_block['accept_rate']}, chi-square "
          f"{sampled_block['chi_square']['stat']} < crit "
          f"{sampled_block['chi_square']['crit_1e-4']}, truncated "
          f"accept {trunc_block['truncated_accept_rate']}, radix "
          f"reduction {radix_block['prefill_reduction']}x with 0 "
          f"registrations + {radix_block['evictions_under_pressure']} "
          f"evictions, parity exact, gates live)")
    return 0


def run_trace_smoke(args):
    """`--trace-smoke`: the observability request plane end to end —
    >= 64 routed requests each leaving a finished `RequestTrace` with
    monotonic queued -> prefill -> decode phase stamps, a two-objective
    SLO fleet driving BOTH good and bad counters non-zero, a mid-run
    hot-swap landing in a flight-recorder dump, and a two-worker
    federated /metrics scrape carrying `worker=` labels."""
    import tempfile
    import urllib.request

    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.monitor import (MetricsRegistry,
                                            SLOObjective, Tracer)
    from deeplearning4j_tpu_torch.monitor.federate import (
        FederationCollector, FederationPublisher, MetricsAggregator)
    from deeplearning4j_tpu_torch.monitor.flightrec import GLOBAL_FLIGHT_RECORDER
    from deeplearning4j_tpu_torch.serving import (FleetRouter, FleetServer,
                                            ModelRegistry)
    from deeplearning4j_tpu_torch.streaming.ndarray import LocalQueueTransport
    from deeplearning4j_tpu_torch.ui import UIServer
    from deeplearning4j_tpu_torch.zoo.transformer import generate

    reg, tracer = MetricsRegistry(), Tracer()
    monitor.enable(registry=reg, tracer=tracer)
    failures = []
    n_req = max(64, args.fleet_post_swap)
    n_tok = 8
    prompt_len = 4
    max_len = prompt_len + n_tok + 4
    max_len += (-max_len) % 4
    mk = lambda seed: build_net(args.vocab, args.fleet_d_model, 1,
                                args.n_heads, max_len, seed=seed,
                                device=args.device)
    alpha_v1, alpha_v2, beta_v1 = mk(31), mk(32), mk(33)
    rng = np.random.default_rng(9)
    distinct = [rng.integers(0, args.vocab, prompt_len)
                for _ in range(8)]
    refs = {"alpha": generate(alpha_v1, np.stack(distinct), n_tok,
                              temperature=0),
            "alpha2": generate(alpha_v2, np.stack(distinct), n_tok,
                               temperature=0),
            "beta": generate(beta_v1, np.stack(distinct), n_tok,
                             temperature=0)}

    root = tempfile.mkdtemp(prefix="trace-smoke-registry-")
    registry = ModelRegistry(root, keep_last=2)
    registry.publish("alpha", alpha_v1)
    registry.publish("beta", beta_v1)
    fleet = FleetServer(registry, device=args.device)
    router = FleetRouter(fleet)
    bps = -(-(prompt_len + n_tok) // 4)
    slots = 4
    common = dict(n_slots=slots, n_blocks=slots * bps + 1, block_len=4,
                  steps_per_dispatch=4,
                  warmup_prompt_len=(prompt_len, prompt_len))
    # alpha: generous objectives -> every request lands GOOD.
    # beta: an impossible TTFT objective -> every request lands BAD
    # (the burn-rate path exercised without dropping a single stream).
    fleet.deploy("alpha", slo=SLOObjective(ttft_s=600.0, tpot_s=600.0),
                 **common)
    fleet.deploy("beta", slo=SLOObjective(ttft_s=1e-9), **common)

    streams = []          # (stream, model, ref_idx)

    def submit(model, i):
        s = router.submit(model, distinct[i % 8], n_tok)
        streams.append((s, model, i % 8))
        return s

    for i in range(n_req // 2):
        submit("alpha" if i % 2 == 0 else "beta", i)
    # ---- mid-run hot-swap: the control-plane event the flight
    # recorder must durably capture
    registry.publish("alpha", alpha_v2)
    swapped_to = fleet.swap("alpha")
    for i in range(n_req // 2, n_req):
        submit("alpha" if i % 2 == 0 else "beta", i)
    errors = 0
    for s, _, _ in streams:
        try:
            s.result(timeout=600)
        except Exception as e:  # noqa: BLE001 — counted below
            errors += 1
            if errors <= 3:
                failures.append(f"trace-smoke stream failed: {e!r}")
    if errors:
        failures.append(f"{errors} trace-smoke streams failed")

    # ---- parity stays the anchor: tracing must not perturb tokens
    bad_parity = 0
    for s, model, ri in streams:
        if s._fut.exception(timeout=0) is not None:
            continue
        key = model if getattr(s, "version", 1) == 1 else "alpha2"
        if not np.array_equal(np.asarray(s.result(timeout=0), np.int64),
                              np.asarray(refs[key][ri], np.int64)):
            bad_parity += 1
    if bad_parity:
        failures.append(f"{bad_parity} streams broke parity under "
                        f"tracing")

    # ---- every request left a finished, monotonic lifecycle trace
    ids = set()
    for s, model, _ in streams:
        tr = getattr(s, "trace", None)
        if tr is None or not tr.finished:
            failures.append(f"{model} stream has no finished trace")
            continue
        ids.add(tr.trace_id)
        names = [p["name"] for p in tr.phases]
        if not (names and names[0] == "queued" and "prefill" in names
                and "decode" in names):
            failures.append(f"trace phases incomplete: {names}")
            continue
        last = tr.t_created
        for p in tr.phases:
            if p["t0"] > p["t1"] or p["t0"] < last - 1e-9:
                failures.append(f"non-monotonic phase stamps: "
                                f"{tr.trace_id} {names}")
                break
            last = p["t0"]
    if len(ids) < 64:
        failures.append(f"only {len(ids)} distinct request traces "
                        f"(need >= 64)")
    lifetimes = sum(1 for e in tracer.events()
                    if str(e.get("name", "")) == "req/lifetime")
    if lifetimes < 64:
        failures.append(f"only {lifetimes} req/lifetime tracer spans")

    # ---- SLO: the two-objective fleet drove BOTH counters
    snap = reg.snapshot()
    good = sum(v["value"] for v in
               snap.get("slo_requests_good_total",
                        {"values": []})["values"])
    bad = sum(v["value"] for v in
              snap.get("slo_requests_bad_total",
                       {"values": []})["values"])
    if good <= 0:
        failures.append("slo_requests_good_total stayed zero")
    if bad <= 0:
        failures.append("slo_requests_bad_total stayed zero")

    # ---- flight recorder: the swap landed in a durable dump
    dump_path = os.path.join(root, "flight.jsonl")
    GLOBAL_FLIGHT_RECORDER.dump(dump_path)
    with open(dump_path) as f:
        dumped = [json.loads(line) for line in f if line.strip()]
    swaps = [e for e in dumped if e.get("kind") == "swap"
             and e.get("model") == "alpha"]
    if not swaps:
        failures.append("mid-run swap missing from the flight-recorder "
                        "dump")

    # ---- federation: two workers, one scrape, worker= labels
    train_reg = MetricsRegistry()
    train_reg.counter("train_steps_total",
                      "optimizer steps (trace-smoke stand-in)").inc(3)
    transport = LocalQueueTransport()
    agg = MetricsAggregator()
    collector = FederationCollector(transport, "metrics", aggregator=agg)
    for worker, r in (("serve0", reg), ("train0", train_reg)):
        FederationPublisher(transport, "metrics", worker,
                            registry=r).publish_once()
    collector.poll()
    if sorted(agg.workers()) != ["serve0", "train0"]:
        failures.append(f"aggregator saw workers {agg.workers()}, "
                        f"expected serve0+train0")
    ui = UIServer(registry=agg).start()
    try:
        base = f"http://127.0.0.1:{ui.port}"
        body = urllib.request.urlopen(f"{base}/metrics",
                                      timeout=10).read().decode()
        for needle in ('worker="serve0"', 'worker="train0"',
                       "slo_requests_good_total",
                       "slo_requests_bad_total", "slo_burn_rate",
                       "train_steps_total"):
            if needle not in body:
                failures.append(f"{needle} missing from the federated "
                                f"/metrics scrape")
        ev_body = urllib.request.urlopen(
            f"{base}/events?format=json&kind=swap",
            timeout=10).read().decode()
        if not json.loads(ev_body)["events"]:
            failures.append("/events route returned no swap events")
    finally:
        ui.stop()

    fleet.stop()
    monitor.disable()
    import shutil
    shutil.rmtree(root, ignore_errors=True)
    if failures:
        for f_ in failures:
            print(f"FAIL: {f_}", file=sys.stderr)
        return 1
    print(f"trace smoke OK ({len(ids)} request traces across 2 models "
          f"(alpha swapped v1->v{swapped_to} mid-run), SLO good={good:g} "
          f"bad={bad:g}, {len(swaps)} swap event(s) in the flight dump, "
          f"federated scrape carries worker=serve0/train0)")
    return 0


def run_alert_smoke(args):
    """`--alert-smoke`: the alert engine + goodput ledger end to end —
    an injected overload drives `serving_shed_total` up and the
    shed-growth rule through firing -> resolved (after the drain), a
    vanished federation worker fires the absence rule and re-publishing
    resolves it, the overload server's goodput ledger conserves every
    dispatched token-position, `/alerts` serves the rule table,
    `serving_goodput_fraction` + `alert_state` are live on `/metrics`,
    and every transition lands in a flight-recorder dump. JAX's
    `compare_bench` gate of a broken goodput fraction waits for the
    port's bench.py (`_gates_not_ported`)."""
    import urllib.request

    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.monitor import (AlertEngine, MetricsRegistry,
                                            Tracer, default_rule_pack)
    from deeplearning4j_tpu_torch.monitor.federate import (
        FederationCollector, FederationPublisher, MetricsAggregator)
    from deeplearning4j_tpu_torch.monitor.flightrec import FlightRecorder
    from deeplearning4j_tpu_torch.monitor.goodput import ttft_decomposition
    from deeplearning4j_tpu_torch.serving import GenerationServer, ShedError
    from deeplearning4j_tpu_torch.streaming.ndarray import LocalQueueTransport
    from deeplearning4j_tpu_torch.ui import UIServer

    reg, tracer = MetricsRegistry(), Tracer()
    monitor.enable(registry=reg, tracer=tracer)
    failures = []
    n_tok, prompt_len, block_len = 16, 4, 4

    # ---- federation plane: the serving registry + one training worker
    # behind an aggregator — the alert engine's snapshot AND liveness
    # source (worker-vanished needs the worker labels)
    train_reg = MetricsRegistry()
    train_reg.counter("train_steps_total",
                      "optimizer steps (alert-smoke stand-in)").inc(3)
    transport = LocalQueueTransport()
    agg = MetricsAggregator()
    collector = FederationCollector(transport, "metrics", aggregator=agg)
    pubs = [FederationPublisher(transport, "metrics", w, registry=r)
            for w, r in (("serve0", reg), ("train0", train_reg))]

    def republish():
        for p in pubs:
            p.publish_once()
        collector.poll()

    recorder = FlightRecorder()
    engine = AlertEngine(agg, default_rule_pack(shed_rate_per_s=0.01),
                         recorder=recorder, registry=reg)

    def state_of(name, states):
        return next(s["state"] for s in states if s["name"] == name)

    # t=0: prime the delta-rate cursors on a healthy plane — nothing
    # may fire before the fault is injected
    republish()
    states = engine.evaluate(now=0.0)
    if state_of("shed-growth", states) != "ok":
        failures.append("shed-growth fired before the overload")
    if state_of("worker-vanished", states) != "ok":
        failures.append("worker-vanished fired with both workers live")

    # ---- inject the overload: a 1-slot server with a tiny queue cap +
    # impossible TTFT SLO takes a 16-stream burst (run_overload shape)
    net = build_net(args.vocab, 16, 1, args.n_heads,
                    prompt_len + n_tok + 4, device=args.device)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, args.vocab, prompt_len) for _ in range(4)]
    nb = -(-(prompt_len + n_tok) // block_len) + 1
    server = GenerationServer(net, n_slots=1, n_blocks=nb,
                              block_len=block_len, max_queue=2,
                              slo_ttft_s=1e-3, device=net.device)
    # warmed on purpose: the compile grid routes into the ledger's
    # `warmup` class, so the fraction is strictly inside (0, 1) and the
    # mode bracket itself is exercised
    server.warmup(prompt_len, n_tok).start()
    streams = [server.generate_async(prompts[i % 4], n_tok)
               for i in range(16)]
    shed = served = 0
    parts = []
    for s in streams:
        try:
            s.result(timeout=600)
            served += 1
            tr = getattr(s, "trace", None)
            dec = ttft_decomposition(tr) if tr is not None else None
            if dec is not None:
                parts.append(dec)
        except ShedError:
            shed += 1
    ledger = server.engine.goodput
    server.stop()
    if shed < 1:
        failures.append("overload shed nothing — no fault to alert on")
    if served < 1 or not parts:
        failures.append("no served stream left a decomposable trace")

    # ---- the ledger survived the overload conserving every position
    snap_gp = ledger.snapshot()
    if not ledger.conserved():
        failures.append(f"goodput ledger broke conservation: {snap_gp}")
    if not 0.0 < snap_gp["goodput_fraction"] < 1.0:
        failures.append(f"overload goodput fraction degenerate: "
                        f"{snap_gp['goodput_fraction']}")

    # t=10: the shed burst is visible as a counter rate -> firing
    republish()
    states = engine.evaluate(now=10.0)
    if state_of("shed-growth", states) != "firing":
        failures.append(f"shed-growth did not fire after the overload "
                        f"(states: {states})")
    # t=20: drained and idle -> the rate falls to zero -> resolved
    republish()
    states = engine.evaluate(now=20.0)
    if state_of("shed-growth", states) != "ok":
        failures.append("shed-growth did not resolve after the drain")

    # ---- worker liveness: train0 vanishes from the scrape, fires;
    # re-publishing it resolves
    agg.drop_worker("train0")
    states = engine.evaluate(now=30.0)
    if state_of("worker-vanished", states) != "firing":
        failures.append("worker-vanished did not fire on a dropped "
                        "worker label")
    republish()
    states = engine.evaluate(now=40.0)
    if state_of("worker-vanished", states) != "ok":
        failures.append("worker-vanished did not resolve on re-publish")

    # ---- every transition landed in the flight recorder
    for kind, want in (("shed_growth", {"firing", "resolved"}),
                       ("worker_vanished", {"firing", "resolved"})):
        got = {e.get("state") for e in recorder.events(kind=kind)}
        if not want <= got:
            failures.append(f"{kind} transitions {sorted(got)} missing "
                            f"{sorted(want - got)} in the recorder")
    dump = recorder.dump()
    for needle in ("shed_growth", "worker_vanished", "resolved"):
        if needle not in dump:
            failures.append(f"{needle} missing from the flight-recorder "
                            f"dump")

    # ---- the acceptance surface: /alerts + the goodput/alert families
    # on /metrics
    ui = UIServer(registry=reg).start()
    ui.attach_alerts(engine)
    try:
        base = f"http://127.0.0.1:{ui.port}"
        body = urllib.request.urlopen(f"{base}/metrics",
                                      timeout=10).read().decode()
        for fam in ("serving_goodput_fraction", "serving_tokens_useful",
                    "serving_shed_total", "alert_state"):
            if fam not in body:
                failures.append(f"{fam} missing from /metrics")
        page = urllib.request.urlopen(f"{base}/alerts",
                                      timeout=10).read().decode()
        for needle in ("shed-growth", "worker-vanished"):
            if needle not in page:
                failures.append(f"{needle} missing from /alerts")
        aj = json.loads(urllib.request.urlopen(
            f"{base}/alerts?format=json", timeout=10).read().decode())
        if not aj.get("attached") or len(aj.get("alerts", [])) < 8:
            failures.append(f"/alerts json incomplete: {aj}")
    finally:
        ui.stop()

    rec = {"platform": _common.card_label(args.device), "value": 1.0,
           "extras": {"goodput": goodput_block(
               {"goodput": snap_gp,
                "goodput_conserved": ledger.conserved(),
                "ttft_parts": parts})}}
    print(json.dumps(rec["extras"], indent=2, sort_keys=True))
    _gates_not_ported("serving_goodput_fraction")

    monitor.disable()
    if failures:
        for f_ in failures:
            print(f"FAIL: {f_}", file=sys.stderr)
        return 1
    print(f"alert+goodput smoke OK (shed {shed}/{shed + served} fired "
          f"and resolved shed-growth, worker-vanished fired+resolved, "
          f"goodput {snap_gp['goodput_fraction']:.3f} over "
          f"{snap_gp['dispatched_total']} positions conserved, "
          f"/alerts + gauges live, transitions in the flight dump)")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--streams", type=int, default=128,
                    help="concurrent streams per phase (the event-"
                         "driven client costs no OS thread per stream)")
    ap.add_argument("--n-tokens", type=int, default=48)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--n-slots", type=int, default=16)
    ap.add_argument("--block-len", type=int, default=8)
    ap.add_argument("--steps-per-dispatch", type=int, default=16,
                    help="decode micro-steps fused per dispatch "
                         "(amortizes the per-step host round-trip; 16 "
                         "keeps 48-token default streams spanning 3 "
                         "chunks, so admissions still interleave "
                         "mid-stream)")
    ap.add_argument("--vocab", type=int, default=101)
    ap.add_argument("--d-model", type=int, default=48,
                    help="48 keeps the matmul weights dominant enough "
                         "that the int8 weight-byte reduction clears "
                         "the >=3.5x acceptance bar")
    ap.add_argument("--n-layers", type=int, default=2)
    ap.add_argument("--n-heads", type=int, default=4)
    ap.add_argument("--max-p99-ttft-s", type=float, default=60.0,
                    help="hard bound on p99 TTFT")
    ap.add_argument("--min-weight-reduction", type=float, default=3.5,
                    help="int8 decode weight-byte reduction floor")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke scale: smaller model, same >=64 "
                         "streams, same hard asserts")
    ap.add_argument("--spec-k", type=int, default=8,
                    help="draft depth for the speculative phase (k "
                         "tokens scored per target dispatch)")
    ap.add_argument("--spec-epochs", type=int, default=None,
                    help="cyclic-LM training epochs for the "
                         "acceptance-friendly workload (default 30 "
                         "full / 40 smoke — the smaller model needs "
                         "more updates to lock the cycle)")
    ap.add_argument("--spec-tokens", type=int, default=48,
                    help="tokens per stream in the speculative/CoW "
                         "phases")
    ap.add_argument("--spec-prompt-len", type=int, default=16,
                    help="prompt (and registered-prefix) length for "
                         "the speculative/CoW phases — two cycle "
                         "periods so the proposer can match inside "
                         "the prompt")
    ap.add_argument("--spec-smoke", action="store_true",
                    help="ONLY the speculative + shared-prefix phases "
                         "at smoke scale, plus the /metrics families "
                         "check")
    ap.add_argument("--sampled-spec-smoke", action="store_true",
                    help="ONLY the sampled-speculation + truncated-"
                         "drafter + radix phases at smoke scale, plus "
                         "the /metrics families check")
    ap.add_argument("--skip-spec", action="store_true",
                    help="skip the speculative, shared-prefix, "
                         "sampled-speculation, truncated-drafter and "
                         "radix phases (5-9) of the default run")
    ap.add_argument("--fleet-streams", type=int, default=12288,
                    help="main-flood streams for the fleet phase "
                         "(split across 2 models; >10k concurrent is "
                         "the acceptance bar)")
    ap.add_argument("--fleet-tokens", type=int, default=32)
    ap.add_argument("--fleet-post-swap", type=int, default=512,
                    help="admissions submitted right after the swap "
                         "pointer flip (the swap-window TTFT sample)")
    ap.add_argument("--fleet-d-model", type=int, default=16,
                    help="fleet-phase models are deliberately tiny — "
                         "the phase measures the deployment plane "
                         "(streams/swap/scale), not model speed")
    ap.add_argument("--fleet-min-sustained", type=int, default=10000)
    ap.add_argument("--skip-fleet", action="store_true",
                    help="skip the multi-model fleet phase")
    ap.add_argument("--fleet-smoke", action="store_true",
                    help="ONLY the fleet phase at smoke scale, plus "
                         "the /metrics + /serving acceptance checks")
    ap.add_argument("--trace-smoke", action="store_true",
                    help="ONLY the observability smoke — request-"
                         "lifecycle traces, SLO burn-rate, flight-"
                         "recorder dump, federated /metrics scrape")
    ap.add_argument("--alert-smoke", action="store_true",
                    help="ONLY the alert-engine + goodput smoke — "
                         "overload-driven rule firing/resolution, "
                         "ledger conservation, /alerts + /metrics "
                         "surfaces, flight-recorder transitions")
    ap.add_argument("--replica-streams", type=int, default=32,
                    help="flood width per arm of the replicated A/B")
    ap.add_argument("--skip-replicated", action="store_true",
                    help="skip the multi-process replicated phase")
    ap.add_argument("--replica-smoke", action="store_true",
                    help="ONLY the horizontal serving phase — "
                         "2-subprocess replica fleet, greedy parity, "
                         "mid-flood replica kill, disagg parity")
    _common.add_device_arg(ap)
    ap.add_argument("--out", default=_common.default_out("serving.json"),
                    help="the ledger's path (never a committed "
                         "BENCH_*.json)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    platform = _common.card_label(device)
    if args.smoke or args.fleet_smoke or args.trace_smoke:
        args.fleet_streams = 256
        args.fleet_tokens = 16
        args.fleet_post_swap = 64
        args.fleet_min_sustained = 128
    if args.smoke or args.replica_smoke:
        # keep the flood a multiple of 2x n_slots (16): each arm's
        # waves pack the slot grid exactly
        args.replica_streams = min(args.replica_streams, 32)
    # flood widths pack the slot grid in full waves (the replicated
    # phase runs n_slots=8 per replica)
    args.fleet_streams = clamp_to_waves(args.fleet_streams,
                                        args.n_slots, "--fleet-streams")
    args.replica_streams = clamp_to_waves(args.replica_streams, 8,
                                          "--replica-streams")
    if args.trace_smoke:
        return run_trace_smoke(args)
    if args.alert_smoke:
        return run_alert_smoke(args)
    if args.replica_smoke:
        from deeplearning4j_tpu_torch import monitor
        monitor.enable()
        replicated_block, failures = run_replicated(args)
        print(json.dumps({"serving_replicated": replicated_block},
                         indent=2, sort_keys=True))
        if failures:
            for f_ in failures:
                print(f"FAIL: {f_}", file=sys.stderr)
            return 1
        rb = replicated_block
        print(f"replicated smoke OK on {platform} (scale "
              f"{rb['replica_scale_x']}x, reported; kill drill "
              f"{rb['kill_drill']['completed']}/"
              f"{rb['kill_drill']['streams']} with "
              f"{rb['kill_drill']['migrated']} migrated, disagg "
              f"{rb['disagg']['parity_vs_colocated']})")
        return 0
    if args.fleet_smoke:
        from deeplearning4j_tpu_torch import monitor
        monitor.enable()
        fleet_block, failures = run_fleet(args, metrics_check=True)
        print(json.dumps({"serving_fleet": fleet_block}, indent=2,
                         sort_keys=True))
        if failures:
            for f_ in failures:
                print(f"FAIL: {f_}", file=sys.stderr)
            return 1
        print(f"fleet smoke OK on {platform} "
              f"({fleet_block['streams_sustained']} concurrent streams, "
              f"swap p99 TTFT {fleet_block['swap_p99_ttft_ms']}ms, "
              f"autoscale {fleet_block['autoscale']})")
        return 0
    if args.smoke or args.spec_smoke or args.sampled_spec_smoke:
        # still >= 64 streams and every hard assert; smaller model and
        # shorter streams, long enough that decode (where continuous
        # batching wins) dominates the per-request prefill. The d16
        # model's weight tree is bias/norm-heavy, which bounds the int8
        # reduction lower — 2.5x still fails a silent fp fallback
        # (~1.0x) by a wide margin.
        args.streams = min(args.streams, 64)
        args.d_model, args.n_tokens, args.prompt_len = 16, 24, 4
        args.n_slots, args.block_len = 8, 4
        args.steps_per_dispatch = 12
        args.min_weight_reduction = 2.5
        args.spec_tokens = 24
    args.streams = clamp_to_waves(args.streams, args.n_slots,
                                  "--streams")
    if args.spec_epochs is None:
        args.spec_epochs = 40 if (args.smoke or args.spec_smoke
                                  or args.sampled_spec_smoke) else 30

    from deeplearning4j_tpu_torch import monitor
    monitor.enable()

    if args.spec_smoke:
        return run_spec_smoke(args)
    if args.sampled_spec_smoke:
        return run_sampled_spec_smoke(args)

    # mixed-phase prompt lengths cycle short/base/long around the base
    # prompt length; the budget must fit the LONGEST + n_tokens
    mixed_lens = sorted({max(2, args.prompt_len // 2), args.prompt_len,
                         args.prompt_len * 2})
    max_len = max(mixed_lens) + args.n_tokens + args.block_len
    max_len += (-max_len) % args.block_len     # budget % block_len == 0
    net = build_net(args.vocab, args.d_model, args.n_layers,
                    args.n_heads, max_len, device=device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, args.vocab, args.prompt_len)
               for _ in range(args.streams)]
    mixed_prompts = [rng.integers(0, args.vocab,
                                  mixed_lens[i % len(mixed_lens)])
                     for i in range(args.streams)]
    # pool: enough blocks to keep every slot busy at FULL sequence
    # size, far fewer than streams * blocks-per-seq — admissions
    # recycle retired blocks
    bps = -(-(max(mixed_lens) + args.n_tokens) // args.block_len)
    n_blocks = args.n_slots * bps + 1

    # each part's host seconds, beside the ledger's blocks
    seconds = {}
    t_part = time.perf_counter()

    def lap(name):
        now = time.perf_counter()
        seconds[name] = round(now - t_part, 3)
        return now

    # ---------------------------------------- phase 1: uniform greedy
    # (both arms best-of-2: single short windows swing with the host's
    # scheduling — timeit-style min)
    ref = reference_tokens(net, prompts, args.n_tokens)
    for _attempt in range(2):
        cont, ttft_ms, cont_wall, stats1 = min(
            (run_continuous(
                net, prompts, args.n_tokens, n_slots=args.n_slots,
                n_blocks=n_blocks, block_len=args.block_len,
                steps_per_dispatch=args.steps_per_dispatch)
             for _ in range(2)), key=lambda out: out[2])
        seq, seq_wall = min(
            (run_sequential(net, prompts, args.n_tokens)
             for _ in range(2)), key=lambda out: out[1])
        if cont_wall < seq_wall:
            break       # bar met — otherwise one retry with fresh
            # windows
    total_tokens = args.streams * args.n_tokens
    cont_tps = total_tokens / cont_wall
    seq_tps = total_tokens / seq_wall
    p50, p99 = np.percentile(ttft_ms, [50, 99])
    ties = {"serving": [], "sequential": [], "serving_mixed_quantized": []}
    parity = greedy_parity(net, prompts, ref, cont, ties=ties["serving"])
    seq_parity = greedy_parity(net, prompts, ref, seq,
                               ties=ties["sequential"])
    t_part = lap("phase1")

    # ------------------------- phase 2: mixed-length + int8 quantized
    qref = reference_tokens(net, mixed_prompts, args.n_tokens,
                            quantize="int8")
    qcont, qttft_ms, q_wall, qstats = run_continuous(
        net, mixed_prompts, args.n_tokens, n_slots=args.n_slots,
        n_blocks=n_blocks, block_len=args.block_len,
        steps_per_dispatch=args.steps_per_dispatch, quantize="int8")
    q_tps = total_tokens / q_wall
    qp50, qp99 = np.percentile(qttft_ms, [50, 99])
    q_parity = greedy_parity(net, mixed_prompts, qref, qcont,
                             quantize="int8",
                             ties=ties["serving_mixed_quantized"])
    t_part = lap("phase2")

    # weight-byte evidence on the decode program (the params tree one
    # greedy decode dispatch reads)
    from deeplearning4j_tpu_torch.serving import PagedDecodeEngine
    rep_fp = PagedDecodeEngine(
        net, n_slots=args.n_slots, n_blocks=n_blocks,
        block_len=args.block_len,
        steps_per_dispatch=args.steps_per_dispatch,
        device=device).decode_cost_report()
    rep_q = PagedDecodeEngine(
        net, n_slots=args.n_slots, n_blocks=n_blocks,
        block_len=args.block_len,
        steps_per_dispatch=args.steps_per_dispatch,
        quantize="int8", device=device).decode_cost_report()
    w_red = rep_fp["weight_bytes"] / rep_q["weight_bytes"]
    mm_red = (rep_fp["matmul_weight_bytes"]
              / rep_q["matmul_weight_bytes"])
    t_part = lap("decode_cost_report")

    # incremental-vs-upfront admission concurrency at one pool size —
    # a POOL-limited configuration (one usable block per slot): with
    # the serving pool itself both modes would be slot-limited and the
    # comparison would measure nothing
    ab = concurrency_ab(net, min(mixed_lens), args.n_tokens,
                        n_slots=args.n_slots,
                        n_blocks=args.n_slots + 1,
                        block_len=args.block_len)

    t_part = lap("concurrency_ab")
    shed, served = run_overload(net, prompts, args.n_tokens,
                                block_len=args.block_len)
    t_part = lap("overload")

    # --------------------------- phase 4: multi-model fleet + hot-swap
    fleet_block, fleet_failures = (
        ({}, []) if args.skip_fleet else run_fleet(args))

    # -------------------- phase 10: horizontal multi-process replicas
    replicated_block, replicated_failures = (
        ({}, []) if args.skip_replicated else run_replicated(args))

    spec_failures = []
    if not args.skip_spec:
        # ----- phases 5+6: speculative decode + shared-prefix CoW A/B
        spec_block, f5, spec_net, spec_max_len = run_speculative(args)
        prefix_block, f6 = run_shared_prefix(args, spec_net, spec_max_len)
        # - phases 7-9: sampled speculation + truncated drafter + radix
        sampled_block, f7, sampled_net, sampled_max_len = \
            run_sampled_spec(args)
        trunc_block, f8 = run_truncated_drafter(args)
        radix_block, f9 = run_radix(args, sampled_net, sampled_max_len)
        spec_failures = f5 + f6 + f7 + f8 + f9

    record = {
        "kind": "serving_loadtest",
        "platform": platform,
        "config": {
            "streams": args.streams, "n_tokens": args.n_tokens,
            "prompt_len": args.prompt_len, "n_slots": args.n_slots,
            "block_len": args.block_len, "n_blocks": n_blocks,
            "steps_per_dispatch": args.steps_per_dispatch,
            "vocab": args.vocab, "d_model": args.d_model,
            "n_layers": args.n_layers, "max_len": max_len,
            "mixed_prompt_lens": mixed_lens,
            "client": "event-driven (future-face await; no per-stream "
                      "OS thread)",
        },
        "extras": {
            "serving": {
                "tokens_per_sec": round(cont_tps, 2),
                "sequential_tokens_per_sec": round(seq_tps, 2),
                "speedup_vs_sequential": round(cont_tps / seq_tps, 3),
                "p50_ttft_ms": round(float(p50), 1),
                "p99_ttft_ms": round(float(p99), 1),
                "wall_seconds": round(cont_wall, 3),
                "sequential_wall_seconds": round(seq_wall, 3),
                "n_streams": args.streams,
                "overload_shed": shed, "overload_served": served,
                "greedy_parity": _parity_word(parity, ties["serving"]),
                "block_grants_total": stats1["block_grants_total"],
                "evict_requeue_total": stats1["evict_requeue_total"],
            },
            "serving_mixed_quantized": {
                "tokens_per_sec": round(q_tps, 2),
                "p50_ttft_ms": round(float(qp50), 1),
                "p99_ttft_ms": round(float(qp99), 1),
                "wall_seconds": round(q_wall, 3),
                "greedy_parity_vs_quantized_generate": _parity_word(
                    q_parity, ties["serving_mixed_quantized"]),
                "weight_bytes_fp32": rep_fp["weight_bytes"],
                "weight_bytes_int8": rep_q["weight_bytes"],
                "weight_bytes_reduction": round(w_red, 3),
                "matmul_weight_bytes_reduction": round(mm_red, 3),
                "decode_bytes_per_step_note":
                    "weight_bytes is the params tree one greedy decode "
                    "dispatch reads (int8 weights + their scales on the "
                    "quantized side)",
                "evict_requeue_total": qstats["evict_requeue_total"],
                "block_grants_total": qstats["block_grants_total"],
                "admitted_incremental": ab["incremental"],
                "admitted_upfront": ab["upfront"],
            },
        },
        # (stream, first differing position, the reference's top-2
        # margin there) of every stream held by margin, per phase
        "near_ties": ties,
        # host seconds of phases 1-3's parts (warmups and references
        # included)
        "seconds": seconds,
    }
    if not args.skip_spec:
        record["extras"]["serving_speculative"] = spec_block
        record["extras"]["serving_prefix"] = prefix_block
        record["extras"]["serving_sampled_spec"] = sampled_block
        record["extras"]["serving_truncated_draft"] = trunc_block
        record["extras"]["serving_radix"] = radix_block
    record["extras"]["goodput"] = goodput_block(stats1)
    if fleet_block:
        record["extras"]["serving_fleet"] = fleet_block
    if replicated_block:
        record["extras"]["serving_replicated"] = replicated_block
    _common.write_ledger(args.out, record)
    s = record["extras"]["serving"]
    q = record["extras"]["serving_mixed_quantized"]
    print(f"[{platform}]")
    print(f"phase1: {s['tokens_per_sec']} tok/s "
          f"(p50 TTFT {s['p50_ttft_ms']}ms, p99 {s['p99_ttft_ms']}ms) | "
          f"sequential {s['sequential_tokens_per_sec']} tok/s | "
          f"speedup {s['speedup_vs_sequential']}x | parity "
          f"{s['greedy_parity']}")
    print(f"phase2 (mixed+int8): {q['tokens_per_sec']} tok/s "
          f"(p50 TTFT {q['p50_ttft_ms']}ms) | weight bytes "
          f"{q['weight_bytes_fp32']}->{q['weight_bytes_int8']} "
          f"({q['weight_bytes_reduction']}x, matmul "
          f"{q['matmul_weight_bytes_reduction']}x) | requeues "
          f"{q['evict_requeue_total']} | admits "
          f"{q['admitted_incremental']} vs {q['admitted_upfront']} "
          f"upfront | parity {q['greedy_parity_vs_quantized_generate']}")
    print(f"overload shed {shed}/{shed + served}")
    print(f"seconds {seconds}")
    gpb = record["extras"]["goodput"]
    cf = gpb["class_fractions"]
    print(f"goodput: {gpb['goodput_fraction']} useful over "
          f"{gpb['dispatched_token_positions']} dispatched positions "
          f"(pad {cf['pad_waste']}, warmup {cf['warmup']}, preempt "
          f"{cf['preempt_discard']}) | TTFT split "
          f"{gpb.get('ttft_decomposition_ms', {})}")
    if not args.skip_spec:
        sp, pf = spec_block, prefix_block
        print(f"phase5 (speculative k={sp['spec_k']}): "
              f"{sp['tokens_per_sec']} tok/s vs "
              f"{sp['baseline_tokens_per_sec']} non-spec "
              f"({sp['speedup_vs_baseline']}x; "
              f"J{sp['chunked_steps_per_dispatch']}-chunked ref "
              f"{sp['baseline_chunked_tokens_per_sec']}) | accept "
              f"{sp['accept_rate']} | {sp['tokens_per_dispatch']} "
              f"tok/disp | parity {sp['greedy_parity']}")
        print(f"phase6 (shared prefix): prefill reduction "
              f"{pf['prefill_reduction']}x over {pf['streams']} streams "
              f"(saved {pf['prefix_tokens_saved']} tokens, "
              f"{pf['prefix_forks']} CoW forks) | p50 TTFT "
              f"{pf['p50_ttft_private_ms']}ms private -> "
              f"{pf['p50_ttft_shared_ms']}ms shared | parity "
              f"{pf['parity_vs_private_blocks']}")
        sb, tb, rb = sampled_block, trunc_block, radix_block
        print(f"phase7 (sampled spec k={sb['spec_k']}, T=0.25): "
              f"{sb['tokens_per_sec']} tok/s vs "
              f"{sb['baseline_tokens_per_sec']} vanilla sampled "
              f"({sb['speedup_vs_baseline']}x) | accept "
              f"{sb['accept_rate']} | chi2 {sb['chi_square']['stat']} < "
              f"crit {sb['chi_square']['crit_1e-4']} "
              f"({sb['chi_square']['status']}) | greedy subset "
              f"{sb['greedy_subset_parity']}")
        print(f"phase8 (truncated drafter "
              f"{tb['draft_layers']}/{tb['model_layers']} layers): accept "
              f"{tb['truncated_accept_rate']} over "
              f"{tb['truncated_proposed']} proposals "
              f"({tb['draft_dispatches']} draft dispatches, n-gram EWMA "
              f"{tb['ngram_accept_ewma']}) | parity {tb['greedy_parity']}")
        print(f"phase9 (radix): prefill reduction "
              f"{rb['prefill_reduction']}x over {rb['streams']} streams "
              f"with {rb['register_prefix_calls']} registrations "
              f"({rb['radix_hit_tokens']} hit tokens, {rb['radix_nodes']} "
              f"nodes, {rb['evictions_under_pressure']} evictions under "
              f"pressure) | parity {rb['parity_vs_private_blocks']}")
    if fleet_block:
        fb = fleet_block
        print(f"phase4 (fleet): {fb['streams_total']} streams over "
              f"{fb['models']} models, sustained "
              f"{fb['streams_sustained']} concurrent | "
              f"{fb['tokens_per_sec']} tok/s | swap v1->v"
              f"{fb['swap']['to_version']} with "
              f"{fb['swap']['inflight_at_flip']} in flight, post-swap "
              f"p99 TTFT {fb['swap_p99_ttft_ms']}ms | autoscale "
              f"{fb['autoscale']} | parity "
              f"{fb['parity_version_tagged']}")
    if replicated_block:
        rb = replicated_block
        kd = rb["kill_drill"]
        print(f"phase10 (replicated): {rb['tokens_per_sec_1r']} -> "
              f"{rb['tokens_per_sec_2r']} tok/s from 1->2 replicas "
              f"({rb['replica_scale_x']}x, reported) | kill drill "
              f"{kd['completed']}/{kd['streams']} completed, "
              f"{kd['migrated']} migrated, parity {kd['parity']} | "
              f"disagg {rb['disagg']['parity_vs_colocated']} | "
              f"parity {rb['greedy_parity_2r']}")
    print(f"ledger -> {args.out}")

    failures = []
    if not parity:
        failures.append("continuous-batched tokens diverge from "
                        "whole-batch generate()")
    if not seq_parity:
        failures.append("sequential baseline diverges from whole-batch "
                        "generate() (harness bug)")
    if not q_parity:
        failures.append("quantized mixed-length streams diverge from "
                        "generate(quantize='int8')")
    # at smoke scale (d16, 24-token streams) the sequential baseline
    # lands within scheduling noise of the continuous server on an
    # uncontended host: the smoke gate catches collapses, the full
    # scale keeps the strict ordering
    tol = 0.9 if args.smoke else 1.0
    if cont_tps <= tol * seq_tps:
        failures.append(f"continuous batching ({cont_tps:.1f} tok/s) "
                        f"does not beat sequential ({seq_tps:.1f})"
                        + (" within the smoke noise band"
                           if tol < 1.0 else ""))
    if max(p99, qp99) > args.max_p99_ttft_s * 1e3:
        failures.append(f"p99 TTFT {max(p99, qp99):.0f}ms exceeds the "
                        f"{args.max_p99_ttft_s}s bound")
    if w_red < args.min_weight_reduction:
        failures.append(
            f"int8 decode weight-byte reduction {w_red:.2f}x below the "
            f"{args.min_weight_reduction}x floor (fp fallback?)")
    if ab["incremental"] < 2 * ab["upfront"]:
        failures.append(
            f"incremental allocation admitted {ab['incremental']} "
            f"streams vs upfront {ab['upfront']} — below the 2x "
            f"concurrency bar")
    if len({p.shape[0] for p in mixed_prompts}) < 2:
        failures.append("mixed phase degenerated to one prompt length")
    if shed < 1:
        failures.append("overload phase shed nothing")
    if not gpb["conserved"]:
        failures.append("goodput ledger broke conservation: class sum "
                        "!= dispatched total")
    if not 0.0 < gpb["goodput_fraction"] < 1.0:
        failures.append(
            f"goodput fraction {gpb['goodput_fraction']} is degenerate "
            f"— accounting path broken (~0: ledger never fed; ~1: "
            f"padding/warmup never counted)")
    failures.extend(fleet_failures)
    failures.extend(replicated_failures)
    failures.extend(spec_failures)
    if failures:
        for f_ in failures:
            print(f"FAIL: {f_}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
