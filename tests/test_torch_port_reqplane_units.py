"""The port's request-plane monitors (`deeplearning4j_tpu_torch/monitor/`
`reqtrace.py`, `goodput.py`, `slo.py`, `xprof.py`) held to the JAX
package's: the cases of the JAX tests `tests/test_observability.py`
`TestSLO` and `TestRequestTrace` and `tests/test_goodput.py`
`TestLedgerUnit` and `TestTTFTDecomposition` (its unit cases; the
serving ones are in `test_torch_port_request_plane.py`), each run on
both packages' copies as one parametrised case (`pkg`), so the port's
answers are the JAX package's. Then the roofline at the H100's peaks,
the cost-report gauges and `ProfilerCapture` over `torch.profiler`.
"""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import json
import os
import types

import pytest

from deeplearning4j_tpu import monitor as jmon
from deeplearning4j_tpu.monitor import goodput as jgoodput
from deeplearning4j_tpu.monitor import reqtrace as jreqtrace
from deeplearning4j_tpu.monitor import slo as jslo
from deeplearning4j_tpu.monitor import xprof as jxprof
from deeplearning4j_tpu_torch import monitor as pmon
from deeplearning4j_tpu_torch.monitor import goodput as pgoodput
from deeplearning4j_tpu_torch.monitor import reqtrace as preqtrace
from deeplearning4j_tpu_torch.monitor import slo as pslo
from deeplearning4j_tpu_torch.monitor import xprof as pxprof

PKGS = {
    "jax": types.SimpleNamespace(monitor=jmon, goodput=jgoodput,
                                 reqtrace=jreqtrace, slo=jslo, xprof=jxprof),
    "port": types.SimpleNamespace(monitor=pmon, goodput=pgoodput,
                                  reqtrace=preqtrace, slo=pslo,
                                  xprof=pxprof),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


@pytest.fixture
def mon(pkg):
    """A fresh registry and tracer swapped in for the package; restored
    after."""
    m = pkg.monitor
    reg, tr = m.MetricsRegistry(), m.Tracer()
    m.enable(registry=reg, tracer=tr)
    yield reg, tr
    m.disable()
    m._STATE.registry = m.GLOBAL_REGISTRY
    m._STATE.tracer = m.GLOBAL_TRACER


# ------------------------------------------------------------------ SLO
class TestSLO:
    def test_objective_validation(self, pkg):
        with pytest.raises(ValueError):
            pkg.slo.SLOObjective()
        with pytest.raises(ValueError):
            pkg.slo.SLOObjective(ttft_s=1.0, target=1.0)

    @pytest.mark.parametrize("ttft,tpot,good", [
        (0.4, 0.05, True), (0.6, 0.05, False), (0.4, 0.2, False),
        (0.4, None, True), (None, 0.05, False)])
    def test_judge_axes(self, pkg, ttft, tpot, good):
        o = pkg.slo.SLOObjective(ttft_s=0.5, tpot_s=0.1)
        assert o.judge(ttft, tpot) is good

    def test_burn_rate_math(self, pkg):
        t = pkg.slo.SLOTracker(pkg.slo.SLOObjective(ttft_s=0.5, target=0.9,
                                                    window_s=60.0))
        for _ in range(9):
            t.record(ttft=0.1, now=1000.0)
        t.record(ttft=9.0, now=1000.0)
        assert t.burn_rate(now=1000.0) == pytest.approx(1.0)
        assert t.good_total == 9 and t.bad_total == 1
        assert t.window_counts(now=1000.0) == {"good": 9, "bad": 1}

    def test_shed_spends_budget_and_window_prunes(self, pkg):
        t = pkg.slo.SLOTracker(pkg.slo.SLOObjective(ttft_s=0.5, target=0.5,
                                                    window_s=10.0))
        t.record_shed(now=0.0)
        assert t.burn_rate(now=0.0) == pytest.approx(2.0)
        assert t.burn_rate(now=100.0) == 0.0
        assert t.bad_total == 1


# --------------------------------------------------------- request traces
class TestRequestTrace:
    def test_phases_flush_to_tracer_on_one_track(self, pkg, mon):
        _, tr = mon
        t = pkg.reqtrace.RequestTrace(model="m")
        t.phase("queued", 1.0, 2.0)
        t.phase("prefill", 2.0, 3.0, slot=0)
        t.event("cow_fork", slot=0)
        t.finish(status="ok", tokens=4)
        tid = pkg.reqtrace._tid_for(t.trace_id)
        evs = [e for e in tr.events() if e.get("tid") == tid]
        names = [e["name"] for e in evs]
        assert "thread_name" in names
        assert {"req/queued", "req/prefill", "req/cow_fork",
                "req/lifetime"} <= set(names)
        life = next(e for e in evs if e["name"] == "req/lifetime")
        assert life["args"]["status"] == "ok"
        assert life["args"]["trace_id"] == t.trace_id
        assert life["args"]["tokens"] == 4

    def test_finish_idempotent_and_offline_safe(self, pkg):
        t = pkg.reqtrace.RequestTrace()
        t.phase("queued", 0.0, 1.0)
        t.finish()
        first = t.t_finished
        t.finish(status="error")
        assert t.t_finished == first and t.status == "ok"

    def test_exemplar_sink_samples(self, pkg, tmp_path):
        sink = tmp_path / "ex.jsonl"
        pkg.reqtrace.set_exemplar_sink(str(sink), sample_every=2)
        try:
            ids = []
            for _ in range(4):
                t = pkg.reqtrace.RequestTrace()
                ids.append(t.trace_id)
                t.finish()
        finally:
            pkg.reqtrace.clear_exemplar_sink()
        kept = [json.loads(line)["trace_id"]
                for line in sink.read_text().splitlines()]
        assert kept == [ids[1], ids[3]]

    def test_mint_trace_id_unique(self, pkg):
        assert pkg.reqtrace.mint_trace_id() != pkg.reqtrace.mint_trace_id()
        assert len(pkg.reqtrace.mint_trace_id()) == 16

    def test_track_ids_and_dict_equal_across_packages(self):
        for tid in ("0123abcd45678901", "ffffffffffffffff"):
            assert preqtrace._tid_for(tid) == jreqtrace._tid_for(tid)
        tj = jreqtrace.RequestTrace(trace_id="abc", model="m", k=1)
        tp = preqtrace.RequestTrace(trace_id="abc", model="m", k=1)
        for t in (tj, tp):
            t.phase("prefill", 1.0, 2.0, slot=3)
            t.annotate(ttft_s=0.5)
        dj, dp = tj.to_dict(), tp.to_dict()
        for d in (dj, dp):
            d.pop("t_created")
            for e in d["events"]:
                e.pop("t")
        assert dj == dp


# ----------------------------------------------------------- the ledger
class TestLedgerUnit:
    def test_conservation_by_construction(self, pkg):
        lg = pkg.goodput.GoodputLedger()
        lg.account(useful=5, pad_waste=3)
        lg.account(useful=2, spec_rejected=4, preempt_discard=1)
        assert lg.dispatched_total == 15
        assert sum(lg.classes.values()) == lg.dispatched_total
        assert lg.conserved() and lg.classes["useful"] == 7
        assert lg.goodput_fraction() == pytest.approx(7 / 15)

    def test_mode_routes_everything(self, pkg):
        lg = pkg.goodput.GoodputLedger()
        lg.set_mode("warmup")
        lg.account(useful=8, pad_waste=2)
        assert lg.classes["warmup"] == 10 and lg.classes["useful"] == 0
        lg.set_mode(None)
        lg.account(useful=5)
        lg.set_mode("drain")
        lg.account(useful=3, pad_waste=1)
        assert lg.classes["drain"] == 4 and lg.conserved()
        assert lg.goodput_fraction() == pytest.approx(5 / 19)

    @pytest.mark.parametrize("call,match", [
        (lambda lg: lg.set_mode("lunch"), "mode"),
        (lambda lg: lg.account(useful=5, pad_waste=-1), "non-negative")])
    def test_bad_input_rejected(self, pkg, call, match):
        with pytest.raises(ValueError, match=match):
            call(pkg.goodput.GoodputLedger())

    def test_zero_total_is_noop_and_fraction_honest_zero(self, pkg):
        lg = pkg.goodput.GoodputLedger()
        lg.account()
        assert lg.dispatched_total == 0 and lg.goodput_fraction() == 0.0

    def test_snapshot_carries_totals(self, pkg):
        lg = pkg.goodput.GoodputLedger()
        lg.account(useful=4, pad_waste=4)
        snap = lg.snapshot()
        assert snap["dispatched_total"] == 8
        assert snap["goodput_fraction"] == pytest.approx(0.5)
        assert set(pkg.goodput.GOODPUT_CLASSES) <= set(snap)

    def test_names_are_jax_names(self):
        assert pgoodput.GOODPUT_CLASSES == jgoodput.GOODPUT_CLASSES
        assert (pgoodput.GOODPUT_COUNTER_FAMILIES
                == jgoodput.GOODPUT_COUNTER_FAMILIES)
        assert (pgoodput.GOODPUT_FRACTION_GAUGE
                == jgoodput.GOODPUT_FRACTION_GAUGE)


# ------------------------------------------------- TTFT decomposition
class TestTTFTDecomposition:
    PHASES = [{"name": "queued", "t0": 1.0, "t1": 1.5, "args": {}},
              {"name": "prefill", "t0": 1.5, "t1": 1.8, "args": {}},
              {"name": "decode", "t0": 1.8, "t1": 2.0, "args": {}}]

    def test_splits_from_host_stamps(self, pkg):
        dec = pkg.goodput.ttft_decomposition(
            {"phases": self.PHASES, "meta": {"ttft_s": 1.0}})
        assert dec == pytest.approx({"queue_wait_s": 0.5, "prefill_s": 0.3,
                                     "first_emit_s": 0.2, "ttft_s": 1.0})

    def test_shed_trace_yields_none(self, pkg):
        assert pkg.goodput.ttft_decomposition(
            {"phases": self.PHASES[:1], "meta": {}}) is None

    def test_missing_ttft_annotation_degrades(self, pkg):
        dec = pkg.goodput.ttft_decomposition(
            {"phases": [dict(self.PHASES[0], t0=0.0, t1=0.4),
                        dict(self.PHASES[1], t0=0.4, t1=0.6)], "meta": {}})
        assert dec["first_emit_s"] == 0.0
        assert dec["ttft_s"] == pytest.approx(0.6)

    def test_trace_object_decomposes(self, pkg):
        t = pkg.reqtrace.RequestTrace()
        t.phase("queued", 0.0, 0.25)
        t.phase("prefill", 0.25, 0.5)
        t.annotate(ttft_s=0.75)
        assert pkg.goodput.ttft_decomposition(t)["first_emit_s"] == \
            pytest.approx(0.25)


# ------------------------------------------------------------ xprof
@pytest.mark.parametrize("flops,nbytes", [(1e12, 1e9), (1e9, 1e10)])
def test_roofline_matches_jax_and_takes_the_h100_peaks(flops, nbytes):
    for dtype in ("float32", "bfloat16"):
        peak = pxprof.H100_PEAK_FLOPS[dtype]
        got = pxprof.roofline(flops, nbytes, dtype=dtype)
        assert got == jxprof.roofline(flops, nbytes, peak, 3.35e12)
    assert pxprof.H100_PEAK_FLOPS == {"bfloat16": 989e12, "float32": 67e12}
    assert pxprof.H100_PEAK_BYTES_PER_SEC == 3.35e12
    r = pxprof.roofline(2e9, 1e9, 1e12, 1e12)
    assert r["bound"] == "compute" and r["predicted_step_seconds"] == 2e-3
    with pytest.raises(ValueError):
        pxprof.roofline(0, 1, dtype="float32")


def test_cost_report_gauges_match_jax(tmp_path):
    rep = {"model": "m", "per_op": {"total_flops_per_step": 10.0,
                                    "total_bytes_per_step": 20.0},
           "roofline": {"predicted_step_seconds": 0.5,
                        "arithmetic_intensity_flop_per_byte": 0.5},
           "program": {"compile_seconds": 1.5}}
    regs = []
    for xp, m in ((jxprof, jmon), (pxprof, pmon)):
        reg = m.MetricsRegistry()
        xp.publish_cost_report(rep, registry=reg)
        regs.append(reg)
        assert xp.cost_reports()["m"] is rep
        xp.clear_cost_reports()
        assert xp.cost_reports() == {}
    jsnap, psnap = (r.snapshot() for r in regs)
    assert {k: [v["value"] for v in s["values"]] for k, s in psnap.items()} \
        == {k: [v["value"] for v in s["values"]] for k, s in jsnap.items()}
    os.makedirs(tmp_path / "PROFILE_x")
    (tmp_path / "PROFILE_x" / "cost_small.json").write_text(
        json.dumps({"model": "small", "per_op": {}}))
    assert set(pxprof.cost_reports(scan=True, root=str(tmp_path))) == \
        set(jxprof.cost_reports(scan=True, root=str(tmp_path))) == {"small"}


def test_profiler_capture_writes_a_trace_and_counts(tmp_path):
    import torch
    reg, tr = pmon.MetricsRegistry(), pmon.Tracer()
    pmon.enable(registry=reg, tracer=tr)
    try:
        with pxprof.ProfilerCapture(str(tmp_path / "cap")) as cap:
            torch.ones(8) @ torch.ones(8)
            with pytest.raises(RuntimeError, match="already active"):
                cap.start()
        assert cap.stop() is None
    finally:
        pmon.disable()
        pmon._STATE.registry = pmon.GLOBAL_REGISTRY
        pmon._STATE.tracer = pmon.GLOBAL_TRACER
    doc = json.loads((tmp_path / "cap" / "trace.json").read_text())
    assert doc["traceEvents"]
    assert reg.counter("profiler_captures_total").value == 1
    assert reg.gauge("profiler_capture_seconds").value > 0
    assert tr.span_names().get("profiler/capture") == 1
