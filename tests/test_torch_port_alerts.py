"""The alert engine (`deeplearning4j_tpu_torch/monitor/alerts.py`) held to
JAX's (`deeplearning4j_tpu/monitor/alerts.py`). Every scenario of JAX's
`tests/test_alerts.py` runs through both packages' engines with the same
rules, the same snapshot sequence and the same explicit `now=`: the rule
states after each pass, the flight recorder's transitions (kind, alert,
state, severity, value) and the `alert_state` gauges must be equal, and
JAX's contract must hold on the port's run. The default rule pack is
JAX's rule for rule."""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import dataclasses
import math
import time
import types

import pytest

from deeplearning4j_tpu.monitor import alerts as jalerts
from deeplearning4j_tpu.monitor import federate as jfed
from deeplearning4j_tpu.monitor.flightrec import FlightRecorder as JRec
from deeplearning4j_tpu.monitor.registry import MetricsRegistry as JReg
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.monitor import alerts as palerts
from deeplearning4j_tpu_torch.monitor import federate as pfed
from deeplearning4j_tpu_torch.monitor.flightrec import FlightRecorder as PRec
from deeplearning4j_tpu_torch.monitor.registry import MetricsRegistry as PReg

JAX = types.SimpleNamespace(A=jalerts, Agg=jfed.MetricsAggregator, Rec=JRec,
                            Reg=JReg)
PORT = types.SimpleNamespace(A=palerts, Agg=pfed.MetricsAggregator,
                             Rec=PRec, Reg=PReg)


def gauge_snap(value, metric="m", **labels):
    return {metric: {"type": "gauge", "help": "",
                     "values": [{"labels": labels, "value": value}]}}


def counter_snap(**families):
    return {name: {"type": "counter", "help": "",
                   "values": [{"labels": lbl, "value": v}
                              for lbl, v in series]}
            for name, series in families.items()}


class Run:
    """One package's engine and the trace of its passes."""

    def __init__(self, pkg, source, rules):
        self.pkg = pkg
        self.rec = pkg.Rec()
        self.out = pkg.Reg()
        self.eng = pkg.A.AlertEngine(source, rules, recorder=self.rec,
                                     registry=self.out)
        self.passes = []

    def eval(self, now):
        states = self.eng.evaluate(now=now)
        self.passes.append([_state_view(s) for s in states])
        return {s["name"]: s for s in states}

    def trace(self):
        events = [{k: v for k, v in e.items() if k not in ("ts", "seq")}
                  for e in self.rec.events()]
        for e in events:
            if isinstance(e.get("value"), float) and math.isnan(e["value"]):
                e["value"] = "nan"
        gauges = self.out.snapshot().get(self.pkg.A.ALERT_STATE_GAUGE, {})
        return self.passes, events, gauges


def _state_view(s):
    v = dict(s)
    if isinstance(v.get("value"), float) and math.isnan(v["value"]):
        v["value"] = "nan"
    return v


# ------------------------------------------------------------ scenarios
# each takes a package namespace and returns its `Run`; the assertions
# are JAX's contract (tests/test_alerts.py), checked on both packages

def sc_flap_inside_window_never_fires(p):
    box = {"v": 0.0}
    r = Run(p, lambda: gauge_snap(box["v"]), [p.A.AlertRule(
        name="hot", kind="threshold", metric="m", op=">", value=10.0,
        for_s=5.0, event_kind="hot_ev")])
    assert r.eval(0.0)["hot"]["state"] == "ok"
    box["v"] = 99.0
    assert r.eval(1.0)["hot"]["state"] == "pending"
    box["v"] = 0.0
    assert r.eval(3.0)["hot"]["state"] == "ok"
    states = {e["state"] for e in r.rec.events(kind="hot_ev")}
    assert "firing" not in states and "resolved" not in states
    return r


def sc_sustained_breach_fires_then_resolves(p):
    box = {"v": 99.0}
    r = Run(p, lambda: gauge_snap(box["v"]), [p.A.AlertRule(
        name="hot", kind="threshold", metric="m", op=">", value=10.0,
        for_s=5.0, severity="page", event_kind="hot_ev")])
    assert r.eval(0.0)["hot"]["state"] == "pending"
    assert r.eval(2.0)["hot"]["state"] == "pending"
    assert r.eval(6.0)["hot"]["state"] == "firing"
    assert r.eng.firing()[0]["name"] == "hot"
    box["v"] = 0.0
    assert r.eval(8.0)["hot"]["state"] == "ok"
    assert [e["state"] for e in r.rec.events(kind="hot_ev")] == [
        "pending", "firing", "resolved"]
    return r


def sc_missing_family_never_breaches(p):
    r = Run(p, lambda: {}, [p.A.AlertRule(
        name="hot", kind="threshold", metric="m", op=">", value=10.0)])
    assert r.eval(0.0)["hot"]["state"] == "ok"
    return r


def sc_label_filter_scopes_series(p):
    snap = {"m": {"type": "gauge", "help": "", "values": [
        {"labels": {"model": "a"}, "value": 99.0},
        {"labels": {"model": "b"}, "value": 1.0}]}}
    r = Run(p, lambda: snap, [p.A.AlertRule(
        name="a-only", kind="threshold", metric="m", labels={"model": "b"},
        op=">", value=10.0)])
    assert r.eval(0.0)["a-only"]["state"] == "ok"
    return r


def sc_aggregates_min_sum_and_nan(p):
    box = {"vals": [5.0, 7.0, float("nan")]}

    def snap():
        return {"m": {"type": "gauge", "help": "", "values": [
            {"labels": {"i": str(i)}, "value": v}
            for i, v in enumerate(box["vals"])]}}
    r = Run(p, snap, [
        p.A.AlertRule(name="lo", kind="threshold", metric="m", op="<",
                      value=6.0, aggregate="min"),
        p.A.AlertRule(name="sum", kind="threshold", metric="m", op=">=",
                      value=12.0, aggregate="sum"),
        p.A.AlertRule(name="hi", kind="threshold", metric="m", op="<=",
                      value=6.0)])
    st = r.eval(0.0)
    assert st["lo"]["state"] == st["sum"]["state"] == "firing"
    assert st["hi"]["state"] == "ok"
    box["vals"] = [6.5, 1.0]
    r.eval(1.0)
    return r


def _worker_rule(p, **kw):
    return p.A.AlertRule(name="worker-vanished", kind="absence", metric=None,
                         severity="page", event_kind="worker_vanished", **kw)


def sc_vanished_worker_fires_and_return_resolves(p):
    agg = p.Agg()
    r1, r2 = p.Reg(), p.Reg()
    r1.counter("a_total", "a").inc()
    r2.counter("b_total", "b").inc()
    agg.ingest_registry(r1, "serve0")
    agg.ingest_registry(r2, "train0")
    r = Run(p, agg, [_worker_rule(p)])
    assert r.eval(0.0)["worker-vanished"]["state"] == "ok"
    agg.drop_worker("train0")
    st = r.eval(1.0)["worker-vanished"]
    assert st["state"] == "firing"
    assert st["context"]["missing"] == ["train0"]
    agg.ingest_registry(r2, "train0")
    assert r.eval(2.0)["worker-vanished"]["state"] == "ok"
    assert [e["state"] for e in r.rec.events(kind="worker_vanished")] == [
        "firing", "resolved"]
    return r


def sc_stale_export_fires(p):
    agg = p.Agg()
    r1 = p.Reg()
    r1.counter("a_total", "a").inc()
    agg.ingest({"worker": "serve0", "ts": time.time() - 100.0,
                "metrics": r1.snapshot()})
    r = Run(p, agg, [_worker_rule(p, stale_s=10.0)])
    st = r.eval(0.0)["worker-vanished"]
    assert st["state"] == "firing" and st["context"]["stale"] == ["serve0"]
    agg.ingest_registry(r1, "serve0")           # a fresh export
    assert r.eval(1.0)["worker-vanished"]["state"] == "ok"
    return r


def sc_plain_registry_source_is_inert(p):
    r = Run(p, p.Reg(), [_worker_rule(p)])
    assert r.eval(0.0)["worker-vanished"]["state"] == "ok"
    return r


def sc_vanished_series_fires(p):
    box = {"snap": {"m": {"type": "gauge", "help": "", "values": [
        {"labels": {"model": "a"}, "value": 1.0},
        {"labels": {"model": "b"}, "value": 1.0}]}}}
    r = Run(p, lambda: box["snap"], [p.A.AlertRule(
        name="gone", kind="absence", metric="m")])
    assert r.eval(0.0)["gone"]["state"] == "ok"
    box["snap"] = gauge_snap(1.0, model="a")
    st = r.eval(1.0)["gone"]
    assert st["state"] == "firing"
    assert st["context"]["missing"] == [{"model": "b"}]
    return r


def sc_rate_fires_and_quiescence_resolves(p):
    box = {"shed": 0.0}
    r = Run(p, lambda: counter_snap(serving_shed_total=[({}, box["shed"])]),
            [p.A.AlertRule(name="shed-growth", kind="delta_rate",
                           metric="serving_shed_total", op=">", value=1.0,
                           aggregate="sum", event_kind="shed_growth")])
    r.eval(0.0)
    box["shed"] = 100.0
    assert r.eval(10.0)["shed-growth"]["state"] == "firing"
    assert r.eval(20.0)["shed-growth"]["state"] == "ok"
    assert [e["state"] for e in r.rec.events(kind="shed_growth")] == [
        "firing", "resolved"]
    return r


def sc_counter_reset_never_negative_rate(p):
    box = {"shed": 100.0}
    r = Run(p, lambda: counter_snap(serving_shed_total=[({}, box["shed"])]),
            [p.A.AlertRule(name="shed-growth", kind="delta_rate",
                           metric="serving_shed_total", op=">",
                           value=-1.0)])
    r.eval(0.0)
    box["shed"] = 0.0
    assert r.eval(10.0)["shed-growth"]["value"] == 0.0
    r.eval(10.0)                                 # dt = 0: no verdict
    return r


def sc_unless_metric_suppresses_rollout(p):
    box = {"swaps": 0.0, "pub": 0.0}
    r = Run(p, lambda: counter_snap(
        fleet_swaps_total=[({}, box["swaps"])],
        registry_published_total=[({}, box["pub"])]),
        [p.A.AlertRule(name="swap-no-pub", kind="delta_rate",
                       metric="fleet_swaps_total", op=">", value=0.0,
                       unless_metric="registry_published_total")])
    r.eval(0.0)
    box["swaps"] += 1
    box["pub"] += 1
    assert r.eval(10.0)["swap-no-pub"]["state"] == "ok"
    box["swaps"] += 1
    assert r.eval(20.0)["swap-no-pub"]["state"] == "firing"
    return r


def sc_only_if_metric_requires_co_increase(p):
    box = {"shed": 0.0, "useful": 0.0}
    r = Run(p, lambda: counter_snap(
        fleet_tenant_shed_total=[({"tenant": "a"}, box["shed"])],
        serving_tokens_useful_total=[({}, box["useful"])]),
        [p.A.AlertRule(name="starved", kind="delta_rate",
                       metric="fleet_tenant_shed_total", op=">", value=1.0,
                       aggregate="sum",
                       only_if_metric="serving_tokens_useful_total")])
    r.eval(0.0)
    box["shed"] += 100
    st = r.eval(10.0)["starved"]
    assert st["state"] == "ok" and st["context"]["only_if_increase"] == 0.0
    box["shed"] += 100
    box["useful"] += 500
    assert r.eval(20.0)["starved"]["state"] == "firing"
    return r


def sc_windowed_average_fires_and_decays(p):
    box = {"v": 20.0}
    r = Run(p, lambda: gauge_snap(box["v"], metric="slo_burn_rate"),
            [p.A.AlertRule(name="slo-burn", kind="burn_rate",
                           metric="slo_burn_rate", op=">",
                           windows=((60.0, 14.0),))])
    assert r.eval(0.0)["slo-burn"]["state"] == "firing"
    box["v"] = 0.0
    r.eval(20.0)
    assert r.eval(40.0)["slo-burn"]["state"] == "ok"
    r.eval(200.0)                                # history ages out
    return r


def sc_all_windows_must_breach(p):
    r = Run(p, lambda: gauge_snap(20.0, metric="slo_burn_rate"),
            [p.A.AlertRule(name="slo-burn", kind="burn_rate",
                           metric="slo_burn_rate", op=">",
                           windows=((60.0, 14.0), (60.0, 100.0)))])
    assert r.eval(0.0)["slo-burn"]["state"] == "ok"
    return r


def sc_states_published_to_registry(p):
    box = {"v": 99.0}
    r = Run(p, lambda: gauge_snap(box["v"]), [p.A.AlertRule(
        name="hot", kind="threshold", metric="m", op=">", value=10.0,
        severity="page")])

    def gauge():
        vals = r.out.snapshot()[p.A.ALERT_STATE_GAUGE]["values"]
        return next(v["value"] for v in vals
                    if v["labels"] == {"alert": "hot", "severity": "page"})
    r.eval(0.0)
    assert gauge() == p.A.STATE_VALUES["firing"] == 2.0
    box["v"] = 0.0
    r.eval(1.0)
    assert gauge() == 0.0
    return r


def _healthy(p):
    reg = p.Reg()
    reg.gauge("checkpoint_last_age_seconds").set(4.0)
    reg.gauge("elastic_live_processes").set(4.0)
    reg.gauge("streaming_watermark_age_seconds").set(2.0)
    reg.gauge("slo_burn_rate").set(0.2)
    reg.counter("serving_shed_total", "sheds").inc(0)
    reg.counter("registry_resolve_fallback_total", "fallbacks")
    reg.counter("fleet_swaps_total", "swaps")
    reg.counter("registry_published_total", "publishes").inc(2)
    reg.counter("serving_radix_evictions_total", "evictions")
    reg.gauge("serving_spec_accept_rate").set(1.0)
    reg.gauge("serving_spec_accept_rate", proposer="ngram").set(0.8)
    return reg


def sc_pack_clean_on_healthy_registry(p):
    r = Run(p, _healthy(p), p.A.default_rule_pack())
    r.eval(0.0)
    assert all(s["state"] == "ok" for s in r.eval(10.0).values())
    assert r.rec.events() == []
    return r


def sc_pack_fires_on_stale_checkpoint(p):
    reg = _healthy(p)
    reg.gauge("checkpoint_last_age_seconds").set(9999.0)
    r = Run(p, reg, p.A.default_rule_pack())
    assert r.eval(0.0)["checkpoint-staleness"]["state"] == "firing"
    assert r.rec.events(kind="checkpoint_stale")
    return r


def sc_pack_fires_on_radix_eviction_churn(p):
    reg = _healthy(p)
    r = Run(p, reg, p.A.default_rule_pack(for_s=0.0))
    r.eval(0.0)
    reg.counter("serving_radix_evictions_total").inc(500)
    assert r.eval(10.0)["radix-eviction-churn"]["state"] == "firing"
    return r


def sc_pack_fires_on_spec_acceptance_collapse(p):
    reg = _healthy(p)
    reg.gauge("serving_spec_accept_rate", proposer="ngram").set(0.01)
    r = Run(p, reg, p.A.default_rule_pack(for_s=0.0))
    assert r.eval(0.0)["sampled-spec-acceptance-collapse"]["state"] == \
        "firing"
    return r


def sc_pack_fires_on_drift_gate_stuck_paused(p):
    reg = _healthy(p)
    reg.gauge("online_publish_paused", tag="tenant-beta").set(1.0)
    r = Run(p, reg, p.A.default_rule_pack(drift_paused_for_s=5.0))
    assert r.eval(0.0)["drift-gate-stuck-paused"]["state"] == "pending"
    assert r.eval(10.0)["drift-gate-stuck-paused"]["state"] == "firing"
    return r


def sc_pack_fires_on_tenant_share_starvation(p):
    reg = _healthy(p)
    shed = reg.counter("fleet_tenant_shed_total", "sheds", tenant="gamma")
    useful = reg.counter("serving_tokens_useful_total", "useful")
    r = Run(p, reg, p.A.default_rule_pack())
    r.eval(0.0)
    shed.inc(100)
    useful.inc(500)
    assert r.eval(10.0)["tenant-share-starvation"]["state"] == "firing"
    return r


def sc_pack_elastic_shrink_fires_and_resolves(p):
    # the elastic plane's rule: live processes below the fleet size for
    # longer than for_s, then the regrow resolves it
    reg = _healthy(p)
    r = Run(p, reg, p.A.default_rule_pack(elastic_min_processes=4))
    assert r.eval(0.0)["elastic-shrink"]["state"] == "ok"
    reg.gauge("elastic_live_processes").set(3.0)
    assert r.eval(1.0)["elastic-shrink"]["state"] == "pending"
    assert r.eval(7.0)["elastic-shrink"]["state"] == "firing"
    reg.gauge("elastic_live_processes").set(4.0)
    assert r.eval(9.0)["elastic-shrink"]["state"] == "ok"
    assert [e["state"] for e in r.rec.events(kind="elastic_shrink")] == [
        "pending", "firing", "resolved"]
    return r


def sc_pack_over_a_federated_aggregator(p):
    # the default pack against a fleet: two workers' registries merged,
    # one vanishes past the stale bound
    agg = p.Agg()
    for w, live in (("w0", 2.0), ("w1", 1.0)):
        reg = _healthy(p)
        reg.gauge("elastic_live_processes").set(live)
        agg.ingest({"worker": w, "ts": time.time() - (50.0 if w == "w1"
                                                      else 0.0),
                    "metrics": reg.snapshot()})
    r = Run(p, agg, p.A.default_rule_pack(elastic_min_processes=2,
                                          worker_stale_s=30.0))
    st = r.eval(0.0)
    assert st["worker-vanished"]["state"] == "firing"
    assert st["worker-vanished"]["context"]["stale"] == ["w1"]
    return r


SCENARIOS = {name[3:]: fn for name, fn in dict(globals()).items()
             if name.startswith("sc_")}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(name):
    jt = SCENARIOS[name](JAX).trace()
    pt = SCENARIOS[name](PORT).trace()
    j_passes, j_events, j_gauges = jt
    p_passes, p_events, p_gauges = pt
    # ages come from the wall clock in the two stale-export scenarios
    for passes in (j_passes, p_passes):
        for states in passes:
            for s in states:
                if s["name"] == "worker-vanished":
                    s["value"] = None if s["value"] is None else round(
                        s["value"])
    assert p_passes == j_passes
    assert p_events == j_events
    assert p_gauges == j_gauges


def test_default_pack_is_jax_s_rule_for_rule():
    kw = dict(checkpoint_stale_s=60.0, elastic_min_processes=3.0,
              worker_stale_s=9.0, for_s=2.0)
    for args in ({}, kw):
        jp = [dataclasses.asdict(r) for r in jalerts.default_rule_pack(**args)]
        pp = [dataclasses.asdict(r) for r in palerts.default_rule_pack(**args)]
        assert pp == jp
    names = sorted(r.name for r in palerts.default_rule_pack())
    assert len(names) == 12 and "elastic-shrink" in names
    pack = palerts.default_rule_pack()
    assert len({r.event_kind for r in pack}) == len(pack)
    assert palerts.GOODPUT_USEFUL_FAMILY == jalerts.GOODPUT_USEFUL_FAMILY
    assert palerts.STATE_VALUES == jalerts.STATE_VALUES


@pytest.mark.parametrize("bad,match", [
    (dict(name="x", kind="vibes", metric="m"), "kind"),
    (dict(name="x", kind="threshold"), "metric"),
    (dict(name="x", kind="burn_rate", metric="m"), "windows"),
    (dict(name="x", kind="threshold", metric="m", op="=="), "op"),
])
def test_rule_validation_as_jax(bad, match):
    for mod in (jalerts, palerts):
        with pytest.raises(ValueError, match=match):
            mod.AlertRule(**bad)


def test_duplicate_rule_name_rejected():
    eng = palerts.AlertEngine(lambda: {}, recorder=PRec(), registry=PReg())
    eng.add_rule(palerts.AlertRule(name="x", kind="threshold", metric="m"))
    with pytest.raises(ValueError, match="duplicate"):
        eng.add_rule(palerts.AlertRule(name="x", kind="threshold",
                                       metric="m"))
    assert [r.name for r in eng.rules] == ["x"]


def test_states_order_firing_first_pages_before_tickets():
    snap = {"a": 1.0, "b": 1.0, "c": 0.0}
    rules = [palerts.AlertRule(name=n, kind="threshold", metric=n, op=">",
                               value=0.5, severity=sev)
             for n, sev in (("c", "page"), ("b", "ticket"), ("a", "page"))]
    eng = palerts.AlertEngine(
        lambda: {k: gauge_snap(v, metric=k)[k] for k, v in snap.items()},
        rules, recorder=PRec(), registry=PReg())
    assert [s["name"] for s in eng.evaluate(now=0.0)] == ["a", "b", "c"]


def test_default_recorder_and_monitor_registry():
    from deeplearning4j_tpu_torch.monitor.flightrec import (
        GLOBAL_FLIGHT_RECORDER)
    reg = monitor.enable(PReg(), jit_compile=False, device_memory=False)
    try:
        n0 = len(GLOBAL_FLIGHT_RECORDER.events(kind="hot_default"))
        eng = palerts.AlertEngine(lambda: gauge_snap(99.0), [
            palerts.AlertRule(name="hot", kind="threshold", metric="m",
                              op=">", value=1.0, event_kind="hot_default")])
        eng.evaluate(now=0.0)
        assert len(GLOBAL_FLIGHT_RECORDER.events(kind="hot_default")) == \
            n0 + 1
        assert "alert_state" in reg.snapshot()
    finally:
        monitor.disable()
    # monitoring off: no gauges, transitions still recorded
    rec = PRec()
    eng = palerts.AlertEngine(lambda: gauge_snap(99.0), [
        palerts.AlertRule(name="cold", kind="threshold", metric="m", op=">",
                          value=1.0)], recorder=rec)
    eng.evaluate(now=0.0)
    assert [e["state"] for e in rec.events()] == ["firing"]
    assert not any(v["labels"].get("alert") == "cold"
                   for v in reg.snapshot()["alert_state"]["values"])


def test_cadence_thread_evaluates_and_stops():
    hits = []
    eng = palerts.AlertEngine(lambda: hits.append(1) or {}, [
        palerts.AlertRule(name="x", kind="threshold", metric="m")],
        recorder=PRec(), registry=PReg())
    with eng.start(interval_s=0.01):
        deadline = time.time() + 10
        while len(hits) < 3 and time.time() < deadline:
            time.sleep(0.01)
    assert len(hits) >= 3 and eng._thread is None


def test_monitor_exports_alert_names():
    for name in ("AlertEngine", "AlertRule", "default_rule_pack", "alerts"):
        assert hasattr(monitor, name) and name in monitor.__all__
