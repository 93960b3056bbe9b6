"""Fleet telemetry federation (`deeplearning4j_tpu_torch/monitor/federate.py`)
held to JAX's `deeplearning4j_tpu/monitor/federate.py`: the same registry
contents, exported at the same timestamps, give both aggregators the same
exposition text and the same merged snapshot; each ingests the other's
exports; the publisher and collector pipe over the port's local queue
transport; `ingest_elastic_status` lifts one coordinator status dict."""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import json

import pytest

from deeplearning4j_tpu.monitor import federate as jfed
from deeplearning4j_tpu.monitor.registry import MetricsRegistry as JRegistry
from deeplearning4j_tpu.streaming.ndarray import (
    LocalQueueTransport as JQueue)
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.monitor import federate as pfed
from deeplearning4j_tpu_torch.monitor.registry import (
    MetricsRegistry as PRegistry)
from deeplearning4j_tpu_torch.streaming.ndarray import (
    LocalQueueTransport as PQueue)

T0 = 1_700_000_000.0


def _populate(reg, worker: int, kind: str):
    """One worker's registry; the same calls on a JAX and a port
    registry."""
    w = worker
    if kind == "counters":
        reg.counter("steps_total", "training steps").inc(3 + w)
        reg.counter("shed_total", "requests shed", model="lm").inc(w)
        reg.counter("shed_total", "requests shed", model="cls").inc(2 * w)
    elif kind == "gauges":
        reg.gauge("queue_depth", "queued requests").set(10 * w + 1)
        reg.gauge("ewma_tok_s", "token rate", slot=str(w % 2)).set(0.5 * w)
    elif kind == "histograms":
        h = reg.histogram("lat_seconds", "latency",
                          buckets=(0.01, 0.1, 1.0))
        for v in (0.005, 0.05 * (w + 1), 0.5, 3.0)[:2 + w]:
            h.observe(v)
    elif kind == "layouts":
        b = (0.01, 0.1, 1.0) if w % 2 == 0 else (0.5, 5.0)
        h = reg.histogram("lat_seconds", "latency", buckets=b)
        h.observe(0.2 * (w + 1))
    elif kind == "timers":
        t = reg.timer("step_seconds", "step time", phase="fwd")
        t.observe(0.02 * (w + 1))
        t.observe(1.5)
    elif kind == "escaping":
        reg.gauge("info", 'help with \\ and "quotes"\nnewline',
                  path='a"b\\c', note="x\ny").set(w)
    elif kind == "mixed":
        _populate(reg, w, "counters")
        _populate(reg, w, "gauges")
        _populate(reg, w, "histograms")
        _populate(reg, w, "timers")
    else:
        raise ValueError(kind)


KINDS = ("counters", "gauges", "histograms", "layouts", "timers",
         "escaping", "mixed")


def _pair(kind, workers=3, ts=None):
    """A JAX and a port aggregator fed the same exports."""
    ja, pa = jfed.MetricsAggregator(), pfed.MetricsAggregator()
    for w in range(workers):
        jr, pr = JRegistry(), PRegistry()
        _populate(jr, w, kind)
        _populate(pr, w, kind)
        t = T0 + (ts[w] if ts else w)
        ja.ingest({"worker": f"w{w}", "ts": t, "metrics": jr.snapshot()})
        pa.ingest({"worker": f"w{w}", "ts": t, "metrics": pr.snapshot()})
    return ja, pa


@pytest.mark.parametrize("kind", KINDS)
def test_exposition_and_snapshot_equal_jax_s(kind):
    ja, pa = _pair(kind)
    assert pa.exposition() == ja.exposition()
    assert pa.snapshot() == ja.snapshot()
    assert pa.workers() == ja.workers() == ["w0", "w1", "w2"]


@pytest.mark.parametrize("kind", ("gauges", "mixed"))
def test_gauge_merge_takes_the_newest_snapshot(kind):
    # worker 0's export is the newest: its gauges win the merge
    ja, pa = _pair(kind, ts=[9.0, 1.0, 2.0])
    assert pa.exposition() == ja.exposition()
    snap = pa.snapshot()
    assert snap["queue_depth"]["values"] == [{"labels": {}, "value": 1.0}]


def test_histograms_bucket_merge_and_degrade():
    _, pa = _pair("histograms")
    merged = pa.snapshot()["lat_seconds"]["values"][0]
    assert merged["count"] == 2 + 3 + 4
    assert merged["buckets"] == [0.01, 0.1, 1.0]
    assert sum(merged["bucket_counts"]) == merged["count"]
    _, pl = _pair("layouts")
    deg = pl.snapshot()["lat_seconds"]["values"][0]
    assert "buckets" not in deg and deg["count"] == 3


def test_last_snapshot_per_worker_wins():
    for fed, Reg in ((jfed, JRegistry), (pfed, PRegistry)):
        agg = fed.MetricsAggregator()
        old, new = Reg(), Reg()
        old.counter("c_total").inc(5)
        new.counter("c_total").inc(7)
        agg.ingest({"worker": "a", "ts": T0 + 2, "metrics": new.snapshot()})
        agg.ingest({"worker": "a", "ts": T0 + 1, "metrics": old.snapshot()})
        assert agg.snapshot()["c_total"]["values"][0]["value"] == 7.0


@pytest.mark.parametrize("form", ("dict", "str", "bytes"))
def test_each_package_ingests_the_other_s_export(form):
    jr, pr = JRegistry(), PRegistry()
    _populate(jr, 1, "mixed")
    _populate(pr, 1, "mixed")
    jexp = jfed.export_snapshot(jr, "w1")
    pexp = pfed.export_snapshot(pr, "w1")
    pexp["ts"] = jexp["ts"]

    def as_form(e):
        if form == "dict":
            return e
        return json.dumps(e) if form == "str" else json.dumps(e).encode()

    pa, ja = pfed.MetricsAggregator(), jfed.MetricsAggregator()
    assert pa.ingest(as_form(jexp)) == "w1"
    assert ja.ingest(as_form(pexp)) == "w1"
    assert pa.exposition() == ja.exposition()


def test_export_ages_and_drop_worker():
    pa = pfed.MetricsAggregator()
    ja = jfed.MetricsAggregator()
    for agg, Reg in ((pa, PRegistry), (ja, JRegistry)):
        r = Reg()
        r.counter("c_total").inc()
        agg.ingest({"worker": "x", "ts": T0, "metrics": r.snapshot()})
        agg.ingest({"worker": "y", "ts": T0 + 4, "metrics": r.snapshot()})
    assert pa.export_ages(now=T0 + 10) == ja.export_ages(now=T0 + 10) \
        == {"x": 10.0, "y": 6.0}
    assert pa.export_ages(now=T0 - 1)["x"] == 0.0
    assert pa.drop_worker("x") and not pa.drop_worker("x")
    assert pa.workers() == ["y"]
    pa.clear()
    assert pa.workers() == [] and pa.exposition() == "\n"


def test_ingest_registry_matches_export_snapshot():
    pr = PRegistry()
    _populate(pr, 0, "mixed")
    agg = pfed.MetricsAggregator()
    assert agg.ingest_registry(pr, "solo") == "solo"
    text = agg.exposition()
    assert 'steps_total{worker="solo"} 3.0' in text
    assert "\nsteps_total 3.0\n" in text


def test_publisher_and_collector_over_the_local_queue():
    def run(fed, Reg, Queue):
        tr, reg = Queue(), Reg()
        _populate(reg, 2, "mixed")
        pub = fed.FederationPublisher(tr, "metrics", "w2", registry=reg)
        col = fed.FederationCollector(tr, "metrics")
        pub.publish_once()
        reg.counter("steps_total", "training steps").inc(100)
        pub.publish_once()
        assert col.poll(timeout=0.01) == 2 and col.ingested_total == 2
        assert pub.published_total == 2
        assert col.poll(timeout=0.01) == 0
        return col.aggregator
    pagg = run(pfed, PRegistry, PQueue)
    jagg = run(jfed, JRegistry, JQueue)
    assert pagg.workers() == jagg.workers() == ["w2"]
    assert pagg.exposition() == jagg.exposition()
    assert pagg.snapshot()["steps_total"]["values"][0]["value"] == 105.0


def test_publisher_thread_and_global_registry():
    tr = PQueue()
    reg = monitor.enable(PRegistry(), jit_compile=False, device_memory=False)
    try:
        reg.counter("beats_total").inc()
        col = pfed.FederationCollector(tr, "m")
        with pfed.FederationPublisher(tr, "m", "bg", interval_s=0.01):
            import time
            deadline = time.time() + 10
            while col.poll(timeout=0.01) == 0 and time.time() < deadline:
                pass
        assert "beats_total" in col.aggregator.snapshot()
    finally:
        monitor.disable()


def _status(metrics_by_token):
    return {"generation": 4, "plan": None, "completed": [],
            "members": {t: {"host": "h", "device_count": 1,
                            "info": ({"step": 3, "metrics": m} if m
                                     else {"step": 3})}
                        for t, m in metrics_by_token.items()}}


def test_ingest_elastic_status_lifts_member_exports():
    jr, pr = JRegistry(), PRegistry()
    for r in (jr, pr):
        r.gauge("elastic_generation").set(4)
        r.counter("elastic_resume_total").inc(2)
    jexp = {"worker": "w0", "ts": T0, "metrics": jr.snapshot()}
    pexp = {"worker": "w0", "ts": T0, "metrics": pr.snapshot()}
    ja, pa = jfed.MetricsAggregator(), pfed.MetricsAggregator()
    assert jfed.ingest_elastic_status(_status({"w0": jexp, "w1": None}),
                                      ja) == 1
    assert pfed.ingest_elastic_status(_status({"w0": pexp, "w1": None}),
                                      pa) == 1
    assert pa.exposition() == ja.exposition()
    assert pfed.ingest_elastic_status({}, pa) == 0


def test_monitor_exports_federation_names():
    for name in ("MetricsAggregator", "FederationPublisher",
                 "FederationCollector", "export_snapshot", "federate"):
        assert hasattr(monitor, name) and name in monitor.__all__
