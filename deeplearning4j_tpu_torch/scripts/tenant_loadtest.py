"""Multi-tenant continuous-learning drill on the port: N tenants, ONE
base model (counterpart of `scripts/tenant_loadtest.py`).

    python -m deeplearning4j_tpu_torch.scripts.tenant_loadtest [--smoke]
        [--device cuda|cpu] [--out build/drivers/tenancy.json]

1. pretrain ONE TransformerLM base (cyclic +1 task), publish it, and
   bootstrap a LoRA adapter per tenant (each tenant's task is a
   DIFFERENT cyclic shift) with the base FROZEN — `publish_adapter`
   ships kilobytes of delta against the pinned base version;
2. serve every tenant from a `TenantFleet` — one in-memory base params
   copy, per-tenant composed views (`shared_base_copies() == 1` is a
   hard assert);
3. under LIVE mixed traffic, each tenant keeps learning on its own
   `online/` stream (`OnlineTrainer` + the registry's adapter publish
   listener + per-tenant `DriftGate`), and a swap watcher hot-swaps
   each freshly published adapter into the fleet — an adapter-pointer
   flip whose in-flight streams finish on the version they started with
   (version-tagged greedy parity, zero dropped streams);
4. one tenant's stream drifts mid-run (label shuffle: its gate trips,
   publishing pauses, recovery republishes); another tenant's stream
   consumer is REPLACED mid-consumption (a new iterator seek()s to the
   old cursor() and training continues exactly where the old member
   stopped);
5. a 10:1 heavy:light fair-share flood: the light tenant's admitted
   share must hold at/above its configured floor while the heavy
   tenant absorbs the shedding.

Hard asserts (exit nonzero):

- >= 3 tenants served from ONE shared base copy;
- every adapter artifact < 5% of the full model zip;
- >= 2 online adapter publishes per tenant and >= 1 hot-swap per
  tenant with traffic in flight somewhere across the flips;
- ZERO dropped streams; every stream bit-equal to whole-batch
  generate() under (base version, adapter version) it was served by;
- the drifting tenant trips its gate, has >= 1 cadence publish
  refused, and publishes again after recovery;
- the membership change loses/duplicates no training batches;
- light tenant's admitted share >= its floor under 10:1 skew, heavy
  tenant sheds more than the light one;
- the training base stays BIT-IDENTICAL through all tenant training;
- the `fleet_tenant_*` / adapter-publish families are live on
  /metrics.

The port's differences: JAX's `--dispatch-floor-ms` (an emulated
device-step floor for CPU load tests) has no counterpart in the port's
server, so the port has no such flag (the ledger's `dispatch_floor_ms`
is null); the `compare_bench` self-gates of the tenancy block wait for
the port's
bench.py (one line names them as not yet ported). The ledger keeps
JAX's keys and goes to `--out` (default `build/drivers/tenancy.json`,
never the committed `BENCH_tenancy.json`).
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

import numpy as np

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.scripts import _common
from deeplearning4j_tpu_torch.scripts.serve_loadtest import clamp_to_waves

# (tenant, cyclic shift of its private task) — the base is trained on
# shift +1, so every tenant's adapter has real work to do
TENANTS = (("acme", 2), ("beta", 3), ("gamma", 5))


def task_records(rng, n, vocab, seq_len, shift):
    """Cyclic-shift sequences: target row = input row + shift (mod V).
    shift=1 is the BASE task; each tenant fine-tunes toward its own
    shift — learnable by a rank-1 adapter, distinct per tenant."""
    out = []
    for _ in range(n):
        start = int(rng.integers(0, vocab))
        ids = (start + np.arange(seq_len)) % vocab
        out.append(np.stack([ids, (ids + shift) % vocab]).astype(np.int32))
    return out


def shuffled_records(rng, recs):
    """Same inputs, random targets — the injected drift segment."""
    out = []
    for r in recs:
        r = r.copy()
        r[1] = rng.integers(0, r.shape[1], r.shape[1])
        out.append(r)
    return out


def params_fingerprint(params):
    """SHA-256 over every raw weight leaf ({layer: {name: array}}, the
    port's `fault.state.model_arrays(net)["params"]`) — the frozen-base
    bit-identity evidence (run before/after all tenant training)."""
    import hashlib
    h = hashlib.sha256()
    for lk in sorted(params, key=int):
        for pk in sorted(params[lk]):
            h.update(f"{lk}:{pk}".encode())
            h.update(np.asarray(params[lk][pk]).tobytes())
    return h.hexdigest()


def fit_batches(lm, rng, steps, batch, vocab, seq_len, shift):
    for _ in range(steps):
        recs = task_records(rng, batch, vocab, seq_len, shift)
        x = np.stack([r[0] for r in recs]).astype(np.float32)
        y = np.eye(vocab, dtype=np.float32)[np.stack([r[1] for r in recs])]
        lm.fit(x, y, epochs=1, batch_size=batch, shuffle=False)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--vocab", type=int, default=32)
    ap.add_argument("--seq-len", type=int, default=8)
    ap.add_argument("--d-model", type=int, default=48)
    ap.add_argument("--n-layers", type=int, default=2)
    ap.add_argument("--n-heads", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--rank", type=int, default=1,
                    help="adapter rank (rank 1 keeps the artifact ~3%% "
                         "of the full zip at d_model 48)")
    ap.add_argument("--alpha", type=float, default=2.0)
    ap.add_argument("--pretrain-steps", type=int, default=60)
    ap.add_argument("--bootstrap-steps", type=int, default=20,
                    help="frozen-base adapter warm-up steps per tenant "
                         "before its v1 adapter publishes")
    ap.add_argument("--clean-steps", type=int, default=24,
                    help="stream batches for the steady tenant (acme)")
    ap.add_argument("--beta-clean-steps", type=int, default=12)
    ap.add_argument("--drift-steps", type=int, default=16,
                    help="label-shuffled batches in beta's drift segment")
    ap.add_argument("--recover-steps", type=int, default=36)
    ap.add_argument("--gamma-steps", type=int, default=24,
                    help="gamma's stream, split in half around the "
                         "elastic membership change")
    ap.add_argument("--publish-every", type=int, default=8)
    ap.add_argument("--eval-every", type=int, default=4)
    ap.add_argument("--drift-band", type=float, default=0.12)
    ap.add_argument("--prompt-len", type=int, default=4)
    ap.add_argument("--gen-tokens", type=int, default=8)
    ap.add_argument("--n-slots", type=int, default=4)
    ap.add_argument("--traffic-inflight", type=int, default=6)
    ap.add_argument("--watermark-s", type=float, default=3.0)
    ap.add_argument("--share-floor", type=float, default=0.10,
                    help="light tenant's guaranteed admitted share")
    ap.add_argument("--fair-heavy-streams", type=int, default=80)
    ap.add_argument("--fair-skew", type=int, default=10,
                    help="heavy:light offered-load ratio")
    ap.add_argument("--fair-slo-s", type=float, default=0.25)
    ap.add_argument("--fair-max-queue", type=int, default=6)
    ap.add_argument("--smoke", action="store_true",
                    help="smoke scale (defaults already are; the "
                         "flag pins the acceptance intent)")
    _common.add_device_arg(ap)
    ap.add_argument("--out", default=_common.default_out("tenancy.json"),
                    help="the ledger's path (never a committed "
                         "BENCH_*.json)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # flood widths pack the slot grid in full waves — enforced with a
    # logged note (the serving loadtest's scale-measurement gotcha)
    args.fair_heavy_streams = clamp_to_waves(
        args.fair_heavy_streams, args.n_slots, "--fair-heavy-streams")
    light_streams = clamp_to_waves(
        max(1, args.fair_heavy_streams // args.fair_skew),
        args.n_slots, "fair light streams")

    from deeplearning4j_tpu_torch import monitor
    monitor.enable()

    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.fault.state import model_arrays
    from deeplearning4j_tpu_torch.online import (
        DriftGate,
        OnlineTrainer,
        StreamingDataSetIterator,
        lm_example,
    )
    from deeplearning4j_tpu_torch.serving import (
        FleetRouter,
        ModelRegistry,
        ShedError,
    )
    from deeplearning4j_tpu_torch.streaming import (
        LocalLogTransport,
        serialize_ndarray,
    )
    from deeplearning4j_tpu_torch.tenancy import TenantFleet, lora
    from deeplearning4j_tpu_torch.zoo.transformer import TransformerLM, generate

    V, T, B, R = args.vocab, args.seq_len, args.batch_size, args.rank
    max_len = args.prompt_len + args.gen_tokens + 4
    max_len += (-max_len) % 4
    max_len = max(max_len, T)
    lm = TransformerLM(vocab_size=V, d_model=args.d_model,
                       n_layers=args.n_layers, n_heads=args.n_heads,
                       max_len=max_len, seed=7).init(device=device)
    rng = np.random.default_rng(0)

    # ---- ONE base, pretrained on the +1 task and published once
    t0 = time.perf_counter()
    fit_batches(lm, rng, args.pretrain_steps, B, V, T, shift=1)
    print(f"pretrained base {args.pretrain_steps} steps "
          f"({time.perf_counter() - t0:.1f}s)")

    import tempfile
    registry_root = tempfile.mkdtemp(prefix="tenant-registry-")
    registry = ModelRegistry(registry_root, keep_last=100)
    base_v = registry.publish("lm", lm)
    base_zip_bytes = registry.path("lm", base_v).stat().st_size
    base_fp = params_fingerprint(model_arrays(lm)["params"])

    # ---- per-tenant adapter bootstrap: frozen base, delta-only publish
    adapters = {}
    adapter_zip_bytes = {}
    for i, (tenant, shift) in enumerate(TENANTS):
        ad = lora.init_adapter(lm, rank=R, seed=100 + i)
        lora.attach_adapter(lm, ad, rank=R, alpha=args.alpha,
                            frozen=True)
        fit_batches(lm, rng, args.bootstrap_steps, B, V, T, shift)
        v = registry.publish_adapter(
            "lm", tenant, lora.extract_adapter(lm),
            base_version=base_v, rank=R, alpha=args.alpha)
        adapters[tenant] = lora.strip_adapter(lm)
        adapter_zip_bytes[tenant] = registry.adapter_path(
            "lm", tenant, v).stat().st_size
    if params_fingerprint(model_arrays(lm)["params"]) != base_fp:
        print("FAIL: base params changed during adapter bootstrap",
              file=sys.stderr)
        return 1
    zip_fraction = max(adapter_zip_bytes.values()) / base_zip_bytes
    print(f"adapters published: "
          f"{ {t: b for t, b in adapter_zip_bytes.items()} } bytes vs "
          f"base zip {base_zip_bytes} (max {zip_fraction:.3f} of full)")

    # ---- the shared-base fleet: every tenant is a deployment over the
    # ONE resolved base params copy
    fleet = TenantFleet(registry, "lm", base_version=base_v,
                        device=device)
    block_len = 4
    bps = -(-(args.prompt_len + args.gen_tokens) // block_len)
    for tenant, _ in TENANTS:
        fleet.deploy(tenant, n_slots=args.n_slots,
                     n_blocks=args.n_slots * bps + 1,
                     block_len=block_len, steps_per_dispatch=4,
                     warmup_prompt_len=(args.prompt_len, args.prompt_len))
    shared_copies = fleet.shared_base_copies()
    router = FleetRouter(fleet)   # no SLO: the swap phase sheds nothing

    probes = [np.asarray((s + np.arange(args.prompt_len)) % V, np.int64)
              for s in range(8)]
    streams = []            # (stream, tenant, probe_idx)
    traffic_on = threading.Event()
    traffic_on.set()
    swap_state = {"swaps": {t: 0 for t, _ in TENANTS},
                  "inflight_at_flip": [], "errors": []}
    names = [t for t, _ in TENANTS]

    def traffic():
        i = 0
        while traffic_on.is_set():
            open_now = sum(1 for s, _, _ in streams
                           if not s._fut.done())
            if open_now < args.traffic_inflight:
                tenant = names[i % len(names)]
                pi = (i // len(names)) % len(probes)
                try:
                    s = router.submit(tenant, probes[pi],
                                      args.gen_tokens)
                    streams.append((s, tenant, pi))
                    i += 1
                except Exception as e:  # noqa: BLE001 — surfaced below
                    swap_state["errors"].append(f"submit: {e!r}")
            time.sleep(0.005)

    def swap_watcher():
        while traffic_on.is_set():
            for tenant, _ in TENANTS:
                try:
                    latest = registry.latest_adapter("lm", tenant)
                    if latest is not None \
                            and latest > fleet.version(tenant):
                        inflight = sum(1 for s, _, _ in streams
                                       if not s._fut.done())
                        fleet.swap(tenant)
                        swap_state["swaps"][tenant] += 1
                        swap_state["inflight_at_flip"].append(inflight)
                except Exception as e:  # noqa: BLE001 — surfaced below
                    swap_state["errors"].append(f"swap {tenant}: {e!r}")
            time.sleep(0.05)

    traffic_thread = threading.Thread(target=traffic, daemon=True)
    watcher_thread = threading.Thread(target=swap_watcher, daemon=True)
    t_traffic0 = time.perf_counter()
    traffic_thread.start()
    watcher_thread.start()

    # ---- continuous learning per tenant, UNDER the live traffic:
    # each tenant streams its own topic; training attaches that
    # tenant's adapter to the one training net (base frozen), the
    # publish listener ships deltas, the watcher swaps them in
    transport = LocalLogTransport()
    heldout = {}
    for tenant, shift in TENANTS:
        hrng = np.random.default_rng(900 + shift)
        hrecs = task_records(hrng, 32, V, T, shift)
        hx = np.stack([r[0] for r in hrecs]).astype(np.float32)
        hy = np.eye(V, dtype=np.float32)[np.stack([r[1] for r in hrecs])]
        heldout[tenant] = DataSet(hx, hy)

    def produce(topic, recs):
        for r in recs:
            transport.send(topic, serialize_ndarray(r))

    def make_iterator(topic):
        return StreamingDataSetIterator(
            transport, topic, batch_size=B,
            record_to_example=lambda r: lm_example(r, vocab_size=V),
            watermark_timeout_s=args.watermark_s, poll_s=0.02)

    summaries = {}
    gates = {}
    listeners = {}
    membership = {}
    for tenant, shift in TENANTS:
        topic = f"lm-{tenant}"
        if tenant == "beta":
            recs = task_records(rng, args.beta_clean_steps * B, V, T,
                                shift)
            recs += shuffled_records(
                rng, task_records(rng, args.drift_steps * B, V, T,
                                  shift))
            recs += task_records(rng, args.recover_steps * B, V, T,
                                 shift)
        elif tenant == "gamma":
            recs = task_records(rng, args.gamma_steps * B, V, T, shift)
        else:
            recs = task_records(rng, args.clean_steps * B, V, T, shift)
        produce(topic, recs)
        total_steps = len(recs) // B

        gate = DriftGate(heldout[tenant], frequency=args.eval_every,
                         band=args.drift_band, tag=f"tenant-{tenant}")
        listener = registry.adapter_publish_listener(
            "lm", tenant, base_version=base_v, rank=R,
            alpha=args.alpha, frequency=args.publish_every,
            gate=gate.allow_publish)
        gates[tenant], listeners[tenant] = gate, listener
        lora.attach_adapter(lm, adapters[tenant], rank=R,
                            alpha=args.alpha, frozen=True)
        it = make_iterator(topic)
        if tenant == "gamma":
            # elastic membership change mid-consumption: the first
            # consumer trains half the stream and leaves; a NEW
            # iterator (the replacement member) seeks to its cursor
            # and finishes the pass — no batch lost, none replayed
            half = total_steps // 2
            s1 = OnlineTrainer(lm, it, listeners=[listener],
                               drift_gate=gate).run(max_steps=half)
            cur = s1.get("cursor")
            it2 = make_iterator(topic)
            it2.seek(cur)
            s2 = OnlineTrainer(lm, it2, listeners=[listener],
                               drift_gate=gate).run(
                                   max_steps=total_steps - half)
            membership = {
                "steps_before": s1["iterations"],
                "steps_after": s2["iterations"],
                "cursor_batch": int(cur.get("batch", -1)),
                "cursor_after": int(s2.get("cursor", {}).get(
                    "batch", -1)),
                "expected_steps": total_steps,
            }
            summary = dict(s2)
            summary["iterations"] = (s1["iterations"]
                                     + s2["iterations"])
        else:
            summary = OnlineTrainer(lm, it, listeners=[listener],
                                    drift_gate=gate).run(
                                        max_steps=total_steps)
        adapters[tenant] = lora.strip_adapter(lm)
        summaries[tenant] = summary
        print(f"tenant {tenant}: {summary['iterations']} stream steps, "
              f"adapter versions {listener.published_versions}, "
              f"gated {listener.gated_skips}, "
              f"trips {gate.trips}")

    base_frozen = params_fingerprint(model_arrays(lm)["params"]) == base_fp

    # ---- drain: let the watcher absorb every final publish and keep
    # the traffic on until every tenant has admitted a stream on its
    # newest adapter (waits on those events, bounded, never a sleep)
    def settled():
        return all(registry.latest_adapter("lm", t) == fleet.version(t)
                   for t, _ in TENANTS)

    def newest_served():
        return all(any(tt == t and getattr(s, "version", None)
                       == fleet.version(t) for s, tt, _ in list(streams))
                   for t, _ in TENANTS)

    deadline = time.monotonic() + 120
    while time.monotonic() < deadline and not (settled()
                                               and newest_served()):
        time.sleep(0.05)
    traffic_on.clear()
    # join BEFORE collecting (a submit racing the flag clear could
    # append an uncollected stream that still decodes at teardown)
    traffic_thread.join(timeout=30)
    watcher_thread.join(timeout=60)
    _common.sync(device)
    traffic_wall = time.perf_counter() - t_traffic0
    dropped = 0
    per_stream = []
    for s, tenant, pi in streams:
        try:
            toks = np.asarray(s.result(timeout=600), np.int64)
            per_stream.append((toks, tenant,
                               getattr(s, "version", None), pi))
        except Exception as e:  # noqa: BLE001 — counted below
            dropped += 1
            if dropped <= 3:
                swap_state["errors"].append(f"stream: {e!r}")

    # ---- version-tagged parity: every stream vs whole-batch
    # generate() under (pinned base) + (the adapter version that
    # served it), composed fresh from the registry artifacts
    base_ref, _ = registry.resolve("lm", base_v, device=device)
    refs = {}
    bad_parity = 0
    for toks, tenant, version, pi in per_stream:
        key = (tenant, version)
        if key not in refs:
            ad, meta, _ = registry.resolve_adapter("lm", tenant,
                                                   version)
            lora.attach_adapter(base_ref, ad, rank=int(meta["rank"]),
                                alpha=float(meta["alpha"]),
                                frozen=True)
            refs[key] = generate(base_ref, np.stack(probes),
                                 args.gen_tokens, temperature=0)
            lora.strip_adapter(base_ref)
        if not np.array_equal(toks,
                              np.asarray(refs[key][pi], np.int64)):
            bad_parity += 1
    versions_served = {t: sorted({v for _, tt, v, _ in per_stream
                                  if tt == t})
                       for t, _ in TENANTS}

    # ---- fair-share flood: 10:1 heavy:light offered load against the
    # STILL-DEPLOYED fleet; the light tenant's floor must hold
    heavy, light = "acme", "gamma"
    router2 = FleetRouter(fleet, slo_ttft_s=args.fair_slo_s,
                          max_queue=args.fair_max_queue,
                          share_floors={light: args.share_floor})
    fair_counts = {heavy: {"admitted": 0, "shed": 0},
                   light: {"admitted": 0, "shed": 0}}
    fs_streams = []

    def fair_submit(tenant, j):
        try:
            fs_streams.append(router2.submit(
                tenant, probes[j % len(probes)], args.gen_tokens))
            fair_counts[tenant]["admitted"] += 1
        except ShedError:
            fair_counts[tenant]["shed"] += 1

    hi = li = 0
    while hi < args.fair_heavy_streams or li < light_streams:
        for _ in range(args.fair_skew):
            if hi < args.fair_heavy_streams:
                fair_submit(heavy, hi)
                hi += 1
        if li < light_streams:
            fair_submit(light, li)
            li += 1
        time.sleep(0.002)
    fair_errors = 0
    for s in fs_streams:
        try:
            s.result(timeout=600)
        except Exception:  # noqa: BLE001 — admitted streams must finish
            fair_errors += 1
    light_share = router2.admitted_share(light)
    heavy_share = router2.admitted_share(heavy)
    snap = monitor.registry().snapshot()
    floor_admits = sum(
        e["value"] for e in snap.get("fleet_tenant_floor_admits_total",
                                     {}).get("values", []))
    fair_block = {
        "floor": args.share_floor,
        "skew": args.fair_skew,
        "light_share": round(light_share, 4),
        "heavy_share": round(heavy_share, 4),
        "floor_margin": round(light_share / args.share_floor, 3),
        "heavy": fair_counts[heavy],
        "light": fair_counts[light],
        "floor_admits": int(floor_admits),
    }
    print(f"fair share: {json.dumps(fair_block, sort_keys=True)}")

    # ---- /metrics acceptance surface
    metrics_failures = []
    import urllib.request

    from deeplearning4j_tpu_torch.ui import UIServer
    ui = UIServer().start()
    try:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{ui.port}/metrics", timeout=10
        ).read().decode()
        for fam in ("fleet_tenant_shed_total",
                    "fleet_tenant_admitted_tokens_total",
                    "fleet_tenant_share",
                    "registry_adapter_published_total",
                    "online_adapter_publishes_total",
                    "online_publish_paused",
                    "online_drift_trips_total"):
            if fam not in body:
                metrics_failures.append(f"{fam} missing from /metrics")
        if 'tenant="acme"' not in body:
            metrics_failures.append(
                "no tenant= label rendered on /metrics")
    finally:
        ui.stop()
    fleet.stop()
    import shutil
    shutil.rmtree(registry_root, ignore_errors=True)

    # ---- ledger + structural compare_bench gate
    online_publishes = {t: len(listeners[t].published_versions)
                        for t, _ in TENANTS}
    rec = {
        "kind": "tenant_loadtest",
        "platform": _common.card_label(device),
        "config": dict({k: getattr(args, k) for k in
                        ("vocab", "seq_len", "d_model", "rank", "alpha",
                         "publish_every", "eval_every", "drift_band",
                         "n_slots", "share_floor", "fair_skew")},
                       dispatch_floor_ms=None),
        "extras": {"serving_tenancy": {
            "tenants": len(TENANTS),
            "shared_base_copies": shared_copies,
            "base_version": base_v,
            "base_zip_bytes": base_zip_bytes,
            "adapter_zip_bytes": adapter_zip_bytes,
            "adapter_zip_fraction": round(zip_fraction, 4),
            "online_adapter_publishes": online_publishes,
            "adapter_versions": {t: registry.adapter_versions("lm", t)
                                 for t, _ in TENANTS},
            "swaps": swap_state["swaps"],
            "inflight_at_flip": swap_state["inflight_at_flip"],
            "streams_total": len(streams),
            "dropped": dropped,
            "tokens_per_sec": round(
                len(per_stream) * args.gen_tokens / traffic_wall, 1),
            "parity": "exact" if bad_parity == 0
                      else f"BROKEN ({bad_parity})",
            "versions_served": versions_served,
            "drift": {
                "trips": gates["beta"].trips,
                "publishes_gated": listeners["beta"].gated_skips,
                "paused_at_end": gates["beta"].paused,
            },
            "membership_change": membership,
            "fair_share": fair_block,
            "base_frozen": ("bit-identical" if base_frozen
                            else "CHANGED"),
        }},
    }
    print(json.dumps(rec, indent=2, sort_keys=True))
    if args.out:
        _common.write_ledger(args.out, rec)
    # JAX's compare_bench self-gates (identical record passes; a second
    # base copy, a base-sized adapter artifact and a collapsed floor each
    # gate) need the port's bench.py
    print("compare_bench self-gates (serving_tenancy shared_base_copies, "
          "adapter_zip_fraction, fair_share floor_margin): not yet ported "
          "(they wait for the port's bench.py)")
    gate_failures = []

    # ---- verdict
    failures = (list(swap_state["errors"][:5]) + metrics_failures
                + gate_failures)
    if shared_copies != 1:
        failures.append(f"{shared_copies} in-memory base copies "
                        f"(must be exactly 1)")
    if zip_fraction >= 0.05:
        failures.append(f"adapter artifact is {zip_fraction:.1%} of "
                        f"the full zip (must be < 5%)")
    for t, _ in TENANTS:
        if online_publishes[t] < 2:
            failures.append(f"tenant {t}: only {online_publishes[t]} "
                            f"online adapter publishes (need >= 2)")
        if swap_state["swaps"][t] < 1:
            failures.append(f"tenant {t}: never hot-swapped under "
                            f"traffic")
        if len(versions_served.get(t, [])) < 2:
            failures.append(f"tenant {t}: served only versions "
                            f"{versions_served.get(t)} (need >= 2 — "
                            f"no pre/post-swap coverage)")
    if not any(n > 0 for n in swap_state["inflight_at_flip"]):
        failures.append("no swap was mid-traffic (0 streams in flight "
                        "at every flip)")
    if dropped:
        failures.append(f"{dropped} serving streams dropped")
    if bad_parity:
        failures.append(f"{bad_parity} streams broke version-tagged "
                        f"greedy parity")
    if gates["beta"].trips < 1:
        failures.append("beta's drift gate never tripped on the "
                        "label-shuffle segment")
    if listeners["beta"].gated_skips < 1:
        failures.append("beta's gate refused no cadence publish")
    if gates["beta"].paused:
        failures.append("beta's gate still paused at end (no recovery)")
    beta_trip_it = next((it_ for it_, _, paused
                         in gates["beta"].history if paused), None)
    if beta_trip_it is not None and not any(
            s > beta_trip_it
            for s in listeners["beta"].published_steps):
        failures.append("no beta publish landed after the drift trip")
    if membership.get("steps_before", 0) + membership.get(
            "steps_after", 0) != membership.get("expected_steps", -1):
        failures.append(f"membership change lost/duplicated batches: "
                        f"{membership}")
    if membership.get("cursor_after") != membership.get(
            "expected_steps"):
        failures.append(f"replacement member's final cursor "
                        f"{membership.get('cursor_after')} != "
                        f"{membership.get('expected_steps')}")
    if not base_frozen:
        failures.append("training base is NOT bit-identical after "
                        "tenant training — the frozen-base contract "
                        "is broken")
    if light_share < args.share_floor:
        failures.append(f"light tenant admitted share "
                        f"{light_share:.3f} fell below its floor "
                        f"{args.share_floor}")
    if fair_counts[heavy]["shed"] < 1:
        failures.append("heavy tenant never shed under 10:1 skew "
                        "(flood mis-tuned)")
    if fair_counts[heavy]["shed"] <= fair_counts[light]["shed"]:
        failures.append(f"heavy tenant did not absorb the shedding: "
                        f"{fair_counts}")
    if fair_errors:
        failures.append(f"{fair_errors} admitted fair-share streams "
                        f"failed to finish")
    if failures:
        for f_ in failures:
            print(f"FAIL: {f_}", file=sys.stderr)
        return 1
    total_swaps = sum(swap_state["swaps"].values())
    print(f"tenant loadtest OK ({len(TENANTS)} tenants on 1 base "
          f"copy, adapters {zip_fraction:.1%} of full zip, "
          f"{total_swaps} mid-traffic swaps over {len(streams)} "
          f"streams, parity exact, beta trips "
          f"{gates['beta'].trips}/gated "
          f"{listeners['beta'].gated_skips}, membership change "
          f"{membership['steps_before']}+{membership['steps_after']} "
          f"steps, light share {light_share:.2f} >= floor "
          f"{args.share_floor})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
