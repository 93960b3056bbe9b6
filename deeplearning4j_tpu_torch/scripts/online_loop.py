"""Online-learning loop on the port: train on a live firehose, serve
the result (counterpart of `scripts/online_loop.py`).

    python -m deeplearning4j_tpu_torch.scripts.online_loop [--smoke]
        [--transport log|queue] [--device cuda|cpu] [--out PATH]

1. a PRODUCER thread publishes token-sequence records onto a
   `streaming/` transport (`LocalLogTransport`, offset-addressable;
   `--transport queue` runs the destructive LocalQueueTransport);
2. an `OnlineTrainer` continuously fine-tunes a TransformerLM from a
   `StreamingDataSetIterator` over that topic, checkpointing through
   the fault runtime and publishing a snapshot into a `ModelRegistry`
   every `--publish-every` steps;
3. a `FleetServer` serves the model behind a `FleetRouter` under LIVE
   decode traffic, and a swap watcher hot-swaps to every published
   version (warmed successor -> pointer flip -> incumbent drain);
4. MID-STREAM the producer injects a label-shuffle segment: the
   held-out `DriftGate` trips (publishing pauses, training continues),
   and once the clean segment resumes and the held-out score recovers,
   publishing resumes.

Hard asserts (exit nonzero):

- >= 2 registry publishes from the stream (cadence + off-cadence final);
- >= 1 hot-swap with traffic in flight at the pointer flip;
- ZERO dropped serving streams across all swaps;
- version-tagged greedy parity: every stream bit-equal to whole-batch
  `generate()` under the registry weights of the version that served
  it;
- the drift gate trips during the shuffle segment (>= 1 trip, with
  >= 1 cadence publish refused) AND publishing resumes after recovery
  (a publish lands at a step after the trip, and the gate ends open);
- the `streaming_*` / `online_*` families are live on /metrics and the
  /train overview renders the staleness row.

The ledger keeps JAX's keys; `platform` names the device (on a card,
its name and power limit). It is written to `--out` when given.
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


def clean_records(rng, n, vocab, seq_len):
    """Cyclic-successor sequences: target row = input row + 1 (mod V) —
    the learnable task the held-out gate scores against."""
    out = []
    for _ in range(n):
        start = int(rng.integers(0, vocab))
        ids = (start + np.arange(seq_len)) % vocab
        out.append(np.stack([ids, (ids + 1) % vocab]).astype(np.int32))
    return out

def shuffled_records(rng, n, vocab, seq_len):
    """Same inputs, random targets — the injected drift segment."""
    out = []
    for r in clean_records(rng, n, vocab, seq_len):
        r[1] = rng.integers(0, vocab, seq_len)
        out.append(r)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--vocab", type=int, default=11)
    ap.add_argument("--seq-len", type=int, default=8)
    ap.add_argument("--d-model", type=int, default=32)
    ap.add_argument("--n-layers", type=int, default=1)
    ap.add_argument("--n-heads", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--pretrain-steps", type=int, default=60,
                    help="clean warm-start steps before the stream "
                         "(the 'fine-tuning' premise: the model serves "
                         "while it keeps learning)")
    ap.add_argument("--clean-steps", type=int, default=24,
                    help="stream batches in the first clean segment")
    ap.add_argument("--drift-steps", type=int, default=20,
                    help="label-shuffled batches in the drift segment")
    ap.add_argument("--recover-steps", type=int, default=40,
                    help="clean batches after the drift segment")
    ap.add_argument("--publish-every", type=int, default=12)
    ap.add_argument("--eval-every", type=int, default=4)
    ap.add_argument("--drift-band", type=float, default=0.12)
    ap.add_argument("--checkpoint-every", type=int, default=20)
    ap.add_argument("--prompt-len", type=int, default=4)
    ap.add_argument("--gen-tokens", type=int, default=8)
    ap.add_argument("--n-slots", type=int, default=4)
    ap.add_argument("--traffic-inflight", type=int, default=4,
                    help="decode streams held open continuously while "
                         "training publishes and the fleet swaps")
    ap.add_argument("--watermark-s", type=float, default=3.0)
    ap.add_argument("--transport", choices=("log", "queue"),
                    default="log",
                    help="'log' = offset-addressable LocalLogTransport "
                         "(resume/replay capable); 'queue' = the "
                         "destructive LocalQueueTransport")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke scale (defaults already are; the "
                         "flag pins the acceptance intent)")
    _common.add_device_arg(ap)
    ap.add_argument("--out", default=None,
                    help="optional JSON ledger path")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    from deeplearning4j_tpu_torch import monitor
    monitor.enable()

    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.online import (
        DriftGate,
        OnlineTrainer,
        StreamingDataSetIterator,
        lm_example,
    )
    from deeplearning4j_tpu_torch.serving import (
        FleetRouter,
        FleetServer,
        ModelRegistry,
    )
    from deeplearning4j_tpu_torch.streaming import (
        LocalLogTransport,
        LocalQueueTransport,
        serialize_ndarray,
    )
    from deeplearning4j_tpu_torch.zoo.transformer import TransformerLM, generate

    V, T, B = args.vocab, args.seq_len, args.batch_size
    max_len = args.prompt_len + args.gen_tokens + 4
    max_len += (-max_len) % 4
    max_len = max(max_len, T)
    lm = TransformerLM(vocab_size=V, d_model=args.d_model,
                       n_layers=args.n_layers, n_heads=args.n_heads,
                       max_len=max_len, seed=3).init(device=device)

    rng = np.random.default_rng(0)

    # ---- warm start on clean batches (the model must be WORTH serving)
    t0 = time.perf_counter()
    for _ in range(args.pretrain_steps):
        recs = clean_records(rng, B, V, T)
        x = np.stack([r[0] for r in recs]).astype(np.float32)
        y = np.eye(V, dtype=np.float32)[np.stack([r[1] for r in recs])]
        lm.fit(x, y, epochs=1, batch_size=B, shuffle=False)
    print(f"pretrained {args.pretrain_steps} steps "
          f"({time.perf_counter() - t0:.1f}s)")

    # ---- held-out tap (clean task, fixed)
    hrng = np.random.default_rng(99)
    hrecs = clean_records(hrng, 32, V, T)
    hx = np.stack([r[0] for r in hrecs]).astype(np.float32)
    hy = np.eye(V, dtype=np.float32)[np.stack([r[1] for r in hrecs])]
    heldout = DataSet(hx, hy)

    # ---- registry + fleet + router + live traffic
    import tempfile
    registry_root = tempfile.mkdtemp(prefix="online-registry-")
    ckpt_root = tempfile.mkdtemp(prefix="online-ckpt-")
    registry = ModelRegistry(registry_root, keep_last=100)
    v1 = registry.publish("lm", lm)
    fleet = FleetServer(registry, device=device)
    block_len = 4
    bps = -(-(args.prompt_len + args.gen_tokens) // block_len)
    fleet.deploy("lm", n_slots=args.n_slots,
                 n_blocks=args.n_slots * bps + 1, block_len=block_len,
                 steps_per_dispatch=4,
                 warmup_prompt_len=(args.prompt_len, args.prompt_len))
    router = FleetRouter(fleet)

    probes = [np.asarray((s + np.arange(args.prompt_len)) % V, np.int64)
              for s in range(V)]
    streams = []            # (stream, probe_idx)
    traffic_on = threading.Event()
    traffic_on.set()
    swap_state = {"swaps": 0, "inflight_at_flip": [], "errors": []}

    def traffic():
        i = 0
        while traffic_on.is_set():
            open_now = sum(1 for s, _ in streams if not s._fut.done())
            if open_now < args.traffic_inflight:
                try:
                    s = router.submit("lm", probes[i % len(probes)],
                                      args.gen_tokens)
                    streams.append((s, i % len(probes)))
                    i += 1
                except Exception as e:  # noqa: BLE001 — surfaced in verdict
                    swap_state["errors"].append(f"submit: {e!r}")
            time.sleep(0.01)

    def swap_watcher():
        while traffic_on.is_set():
            try:
                latest = registry.latest("lm")
                if latest is not None and latest > fleet.version("lm"):
                    inflight = sum(1 for s, _ in streams
                                   if not s._fut.done())
                    fleet.swap("lm")
                    swap_state["swaps"] += 1
                    swap_state["inflight_at_flip"].append(inflight)
            except Exception as e:  # noqa: BLE001 — surfaced in verdict
                swap_state["errors"].append(f"swap: {e!r}")
            time.sleep(0.05)

    traffic_thread = threading.Thread(target=traffic, daemon=True)
    traffic_thread.start()
    watcher_thread = threading.Thread(target=swap_watcher, daemon=True)
    watcher_thread.start()

    # ---- the firehose: clean → label-shuffled drift → clean recovery
    transport = (LocalLogTransport() if args.transport == "log"
                 else LocalQueueTransport())
    topic = "lm-train"
    segments = [("clean", clean_records(rng, args.clean_steps * B, V, T)),
                ("drift", shuffled_records(rng, args.drift_steps * B, V, T)),
                ("recover", clean_records(rng, args.recover_steps * B, V, T))]
    total_steps = (args.clean_steps + args.drift_steps
                   + args.recover_steps)

    def produce():
        for _, recs in segments:
            for r in recs:
                transport.send(topic, serialize_ndarray(r))

    producer = threading.Thread(target=produce, daemon=True)
    producer.start()

    # ---- continuous fine-tuning, publishing into the fleet's registry
    stream_it = StreamingDataSetIterator(
        transport, topic, batch_size=B,
        record_to_example=lambda r: lm_example(r, vocab_size=V),
        watermark_timeout_s=args.watermark_s, poll_s=0.02)
    gate = DriftGate(heldout, frequency=args.eval_every,
                     band=args.drift_band)
    trainer = OnlineTrainer(
        lm, stream_it, registry=registry, model_name="lm",
        publish_frequency=args.publish_every,
        checkpoint_dir=ckpt_root,
        checkpoint_frequency=args.checkpoint_every, drift_gate=gate)
    t1 = time.perf_counter()
    summary = trainer.run(max_steps=total_steps)
    _common.sync(device)
    train_wall = time.perf_counter() - t1
    producer.join(timeout=30)

    # ---- drain traffic, then settle any still-pending swap
    for _ in range(200):      # let the watcher catch a final publish
        if registry.latest("lm") == fleet.version("lm"):
            break
        time.sleep(0.05)
    traffic_on.clear()
    # join BEFORE collecting: a submit racing the flag clear could
    # append one more stream after the await loop snapshotted the
    # list — uncollected, unaccounted, and still decoding when
    # fleet.stop() tears the engine down
    traffic_thread.join(timeout=30)
    watcher_thread.join(timeout=60)
    dropped = 0
    per_stream = []
    for s, pi in streams:
        try:
            toks = np.asarray(s.result(timeout=600), np.int64)
            per_stream.append((toks, getattr(s, "version", None), pi))
        except Exception as e:  # noqa: BLE001 — counted below
            dropped += 1
            if dropped <= 3:
                swap_state["errors"].append(f"stream: {e!r}")

    # ---- version-tagged parity: every stream vs generate() under the
    # registry weights of the version that served it
    refs = {}
    bad_parity = 0
    for toks, version, pi in per_stream:
        if version not in refs:
            net_v, _ = registry.resolve("lm", version, device=device)
            refs[version] = generate(net_v, np.stack(probes),
                                     args.gen_tokens, temperature=0)
        if not np.array_equal(toks, np.asarray(refs[version][pi],
                                               np.int64)):
            bad_parity += 1

    versions_served = sorted({v for _, v, _ in per_stream})
    publishes = summary.get("published_versions", [])
    pub_steps = summary.get("published_steps", [])
    trip_iteration = next((it for it, _, paused in gate.history
                           if paused), None)
    resumed_publish = (trip_iteration is not None
                       and any(s > trip_iteration for s in pub_steps))

    # ---- /metrics + /train acceptance surface
    metrics_failures = []
    import urllib.request

    from deeplearning4j_tpu_torch.ui import UIServer
    ui = UIServer().start()
    try:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{ui.port}/metrics", timeout=10
        ).read().decode()
        for fam in ("streaming_records_consumed_total",
                    "streaming_lag_records",
                    "streaming_watermark_age_seconds",
                    "online_publishes_total", "online_publish_paused",
                    "online_drift_trips_total"):
            if fam not in body:
                metrics_failures.append(f"{fam} missing from /metrics")
        page = urllib.request.urlopen(
            f"http://127.0.0.1:{ui.port}/train/overview", timeout=10
        ).read().decode()
        if "streaming / online training" not in page:
            metrics_failures.append(
                "/train overview lacks the streaming staleness row")
    finally:
        ui.stop()
    fleet.stop()
    import shutil
    for root in (registry_root, ckpt_root):
        shutil.rmtree(root, ignore_errors=True)

    verdict = {
        "kind": "online_loop",
        "platform": _common.card_label(device),
        "config": {k: getattr(args, k) for k in
                   ("vocab", "seq_len", "d_model", "batch_size",
                    "publish_every", "eval_every", "drift_band",
                    "transport")},
        "train": {
            "steps": summary["iterations"],
            "wall_seconds": round(train_wall, 2),
            "published_versions": publishes,
            "published_steps": pub_steps,
            "publishes_gated": summary.get("publishes_gated", 0),
            "drift_trips": summary.get("drift_trips", 0),
            "heldout_best": summary.get("heldout_best"),
            "heldout_last": summary.get("heldout_last"),
            "publish_paused_at_end": summary.get("publish_paused"),
            "cursor": summary.get("cursor"),
        },
        "serving": {
            "initial_version": v1,
            "streams_total": len(streams),
            "dropped": dropped,
            "swaps": swap_state["swaps"],
            "inflight_at_flip": swap_state["inflight_at_flip"],
            "versions_served": versions_served,
            "parity": "exact" if bad_parity == 0
                      else f"BROKEN ({bad_parity})",
        },
    }
    print(json.dumps(verdict, indent=2, sort_keys=True))
    if args.out:
        _common.write_ledger(args.out, verdict)

    failures = list(swap_state["errors"][:5]) + metrics_failures
    if len(publishes) < 2:
        failures.append(f"only {len(publishes)} registry publishes "
                        f"(need >= 2)")
    if swap_state["swaps"] < 1:
        failures.append("no hot-swap happened")
    if swap_state["swaps"] >= 1 and not any(
            n > 0 for n in swap_state["inflight_at_flip"]):
        failures.append("no swap was mid-traffic (0 streams in flight "
                        "at every flip)")
    if dropped:
        failures.append(f"{dropped} serving streams dropped — the "
                        f"zero-dropped-streams contract is broken")
    if bad_parity:
        failures.append(f"{bad_parity} streams broke version-tagged "
                        f"greedy parity")
    if summary.get("drift_trips", 0) < 1:
        failures.append("drift gate never tripped on the label-shuffle "
                        "segment")
    if summary.get("publishes_gated", 0) < 1:
        failures.append("gate tripped but refused no cadence publish "
                        "(cadence/segment lengths mis-tuned)")
    if summary.get("publish_paused") is not False:
        failures.append("publish gate still paused at end of stream "
                        "(no recovery)")
    if not resumed_publish:
        failures.append("no publish landed after the drift trip — "
                        "publishing did not resume")
    if failures:
        for f_ in failures:
            print(f"FAIL: {f_}", file=sys.stderr)
        return 1
    print(f"online loop OK ({summary['iterations']} stream steps, "
          f"{len(publishes)} publishes {publishes}, "
          f"{swap_state['swaps']} mid-traffic swaps over "
          f"{len(streams)} streams, drift trips "
          f"{summary['drift_trips']}, gated "
          f"{summary['publishes_gated']}, parity exact)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
