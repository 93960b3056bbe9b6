"""The port's telemetry (`deeplearning4j_tpu_torch/monitor/`) against the
JAX package's (`deeplearning4j_tpu/monitor/`): the registry's
Prometheus exposition after the same operations is the same text; the
tracer, the flight recorder and the enable/disable contract behave as
JAX's; `fit` with monitoring on runs its spans and feeds the registry;
the collectors, the listeners' gauges and the checkpoint counters land
under JAX's family names."""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import json

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.monitor.flightrec import FlightRecorder as JaxFR
from deeplearning4j_tpu.monitor.registry import MetricsRegistry as JaxReg
from deeplearning4j_tpu.monitor.tracer import Tracer as JaxTracer
from deeplearning4j_tpu_torch import fault, monitor
from deeplearning4j_tpu_torch.common.updaters import Adam
from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator
from deeplearning4j_tpu_torch.kernels import build
from deeplearning4j_tpu_torch.monitor.flightrec import FlightRecorder
from deeplearning4j_tpu_torch.monitor.registry import MetricsRegistry
from deeplearning4j_tpu_torch.monitor.tracer import NOOP_SPAN, Tracer
from deeplearning4j_tpu_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.listeners import (
    EvaluativeListener,
    ParamAndGradientIterationListener,
    ProfilerListener,
    TrainingListener,
)


def _ops(reg):
    """The same writes into either package's registry."""
    reg.counter("training_iterations_total", help="fit iterations",
                model="a").inc(3)
    reg.counter("jax_transfers_total", help="copies",
                direction="d2h").inc()
    reg.gauge("training_score", help="loss\nwith \\ newline",
              model='q"uo\nte').set(0.25)
    reg.gauge("nan_gauge").set(float("nan"))
    reg.gauge("inf_gauge").set(float("-inf"))
    h = reg.histogram("training_etl_seconds", help="etl", model="a")
    for v in (0.0002, 0.003, 7.0, 500.0):
        h.observe(v)
    t = reg.timer("checkpoint_write_seconds", buckets=(0.1, 1.0))
    t.observe(0.5)
    reg.gauge("fn_gauge").set_function(lambda: 42.0)
    reg.gauge("broken_gauge").set_function(lambda: 1 / 0)


def test_registry_exposition_is_jaxs_letter_for_letter():
    port, jax_ = MetricsRegistry(), JaxReg()
    _ops(port)
    _ops(jax_)
    assert port.exposition() == jax_.exposition()
    assert (json.dumps(port.snapshot(), sort_keys=True, default=str)
            == json.dumps(jax_.snapshot(), sort_keys=True, default=str))
    with pytest.raises(ValueError):
        port.gauge("training_iterations_total")
    with pytest.raises(ValueError):
        port.counter("x").inc(-1)


def test_tracer_spans_ring_and_chrome_export():
    for cls in (Tracer, JaxTracer):
        tr = cls(max_events=3)
        with tr.span("outer", a=1):
            with tr.span("inner") as s:
                s.set(b=2)
        tr.instant("mark")
        tr.complete_between("etl", 1.0, 1.5, iteration=0)
        assert tr.events_dropped == 1
        assert tr.span_names() == {"outer": 1, "etl": 1}
        doc = json.loads(tr.export_chrome_trace())
        assert [e["name"] for e in doc["traceEvents"]] == ["outer", "mark",
                                                           "etl"]
        assert doc["otherData"]["events_dropped"] == 1
    assert cls is JaxTracer and Tracer(enabled=False).span("x") is NOOP_SPAN


def test_flight_recorder_matches_jax(tmp_path):
    port, jax_ = FlightRecorder(capacity=2), JaxFR(capacity=2)
    for fr in (port, jax_):
        fr.attach_file(str(tmp_path / f"{id(fr)}.jsonl"))
        for i in range(3):
            fr.record("watchdog_halt", iteration=i, layers=["0"])
    strip = lambda evs: [{k: v for k, v in e.items() if k != "ts"}
                         for e in evs]
    assert strip(port.events()) == strip(jax_.events())
    assert port.dropped == jax_.dropped == 1
    assert len(port.events(kind="watchdog_halt", last=1)) == 1
    lines = (tmp_path / f"{id(port)}.jsonl").read_text().splitlines()
    assert len(lines) == 3


def _mlp(diagnostics=None):
    conf = (NeuralNetConfiguration.builder().seed(7).updater(Adam(0.01))
            .list().layer(DenseLayer(n_in=4, n_out=6, activation="relu"))
            .layer(OutputLayer(n_in=6, n_out=3, activation="softmax",
                               loss="mcxent")).build())
    return MultiLayerNetwork(conf, device="cpu",
                             diagnostics=diagnostics).init()


def _data(n=24, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 4)).astype(np.float32),
            np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)])


@pytest.fixture
def mon():
    reg = monitor.enable(registry=MetricsRegistry(), tracer=Tracer())
    yield reg
    monitor.disable()


def test_disabled_is_a_shared_noop():
    assert not monitor.is_enabled()
    assert monitor.resolve_cached_metrics(object(), "_m", None) is None
    assert monitor.span("fit/update") is NOOP_SPAN
    assert monitor.extra_listeners() == []
    before = monitor.registry().exposition()
    monitor.record_transfer(100, "d2h")
    assert monitor.registry().exposition() == before


@pytest.mark.parametrize("spe", [1, 3])
def test_fit_runs_spans_and_feeds_the_registry(mon, spe):
    x, y = _data()
    net = _mlp(diagnostics=True)
    net.fit(x, y, epochs=1, batch_size=4, shuffle=False,
            steps_per_execution=spe)
    names = monitor.tracer().span_names()
    groups = 6 // spe
    assert names["fit/forward_backward"] == groups
    assert names["fit/update"] == groups
    assert names["fit/etl"] == 6
    # a diagnostics step's parts, once a step (the loss is read per step
    # only outside a group)
    for part in ("fit/snapshot", "fit/apply_updates", "fit/collect_and_gate"):
        assert names[part] == 6, part
    assert names.get("fit/read_loss", 0) == (6 if spe == 1 else 0)
    assert mon.counter("training_iterations_total",
                       model="default").value == 6
    assert mon.counter("training_examples_total",
                       model="default").value == 24
    assert mon.counter("training_fits_total", model="default").value == 1
    assert mon.counter("training_epochs_total", model="default").value == 1
    assert mon.counter("jax_transfers_total",
                       direction="d2h").value == groups
    text = mon.exposition()
    for family in ("training_score", "training_grad_l2",
                   "training_update_l2", "training_update_ratio",
                   "training_activation_std", "training_activation_dead",
                   "training_etl_seconds_bucket", "tracer_events_dropped_total"):
        assert family in text, family


def test_collectors(mon, monkeypatch):
    class Holder:
        pass
    h, built = Holder(), []
    fams = monitor.resolve_cached_metrics(
        h, "_m", lambda reg: built.append(reg) or reg.counter("c"))
    assert monitor.resolve_cached_metrics(h, "_m", None) is fams
    assert built == [mon]
    coll = monitor.compile_collector()
    # one finished build, as `build._finish` counts it
    monkeypatch.setattr(build, "BUILDS", build.BUILDS + 1)
    monkeypatch.setattr(build, "BUILD_SECONDS", build.BUILD_SECONDS + 2.5)
    assert coll.compile_count() == 1 and coll.compile_seconds() == 2.5
    assert 'jax_compile_seconds_total{stage="nvcc_build"} 2.5' in \
        mon.exposition()
    monitor.disable()
    monkeypatch.setattr(build, "BUILDS", build.BUILDS + 1)
    assert coll.compile_count() == 1
    assert monitor.memory_collector().collect() is (
        torch.cuda.is_available())
    # the parallel trainers' phase events land on the registry
    from deeplearning4j_tpu_torch.parallel import TrainingMasterStats
    stats = monitor.bind_master_stats(TrainingMasterStats(), mon)
    stats.record("sync_step", 0.002, iteration=0)
    assert mon.counter("parallel_phase_total",
                       phase="sync_step").value == 1
    assert "parallel_phase_seconds" in mon.exposition()


def test_listeners(mon, tmp_path):
    x, y = _data()
    printed, seen = [], {}

    class Seen(TrainingListener):
        def iteration_done(self, model, iteration, epoch, score, **info):
            seen[iteration] = info["diagnostics"]
    net = _mlp(diagnostics=True)
    net.set_listeners(
        EvaluativeListener(ArrayDataSetIterator(x, y, batch_size=8),
                           invocation="iteration_end", frequency=3,
                           printer=lambda s: None, tag="held"),
        ParamAndGradientIterationListener(print_iterations=2,
                                          printer=printed.append),
        ProfilerListener(str(tmp_path), start_iteration=1,
                         num_iterations=2), Seen())
    net.fit(x, y, epochs=1, batch_size=4, shuffle=False)
    acc = mon.gauge("evaluative_score", tag="held", metric="accuracy").value
    assert acc == net.evaluate(ArrayDataSetIterator(x, y)).accuracy()
    assert mon.gauge("evaluative_last_iteration", tag="held").value == 3
    assert len(printed) == 3 and "|g|=" in printed[0]
    st = seen[4]["params"]["0_W"]
    assert f"0_W: |p|={st['param_mm']:.4g} |g|={st['grad_mm']:.4g}" \
        in printed[-1]
    prof = net.listeners[2]
    assert len(prof.trace_dirs()) == 1
    # without diagnostics: the params' magnitudes in one readback
    plain, lines = _mlp(), []
    plain.set_listeners(ParamAndGradientIterationListener(
        printer=lines.append))
    plain.fit(x[:4], y[:4], batch_size=4)
    want = float(plain.layers[0].jax_param_map()["W"].abs().mean())
    assert f"0_W: |p|={want:.4g}" in lines[0] and "|g|" not in lines[0]


def test_checkpoint_and_restore_counters(mon, tmp_path):
    x, y = _data(16)
    net = _mlp()
    # inline writes: the background writer is latest-wins, so a save
    # that finds it busy replaces the queued one and the count would
    # depend on the disk's speed
    ck = fault.AsyncCheckpointer(str(tmp_path), keep_last=2,
                                 async_write=False)
    net.add_listener(fault.CheckpointListener(ck, frequency=2))
    net.fit(x, y, epochs=1, batch_size=4, shuffle=False)
    ck.wait()
    assert mon.counter("checkpoint_total").value == 2
    assert mon.gauge("checkpoint_last_step").value == 4
    assert mon.counter("checkpoint_bytes_total").value > 0
    assert mon.gauge("checkpoint_last_age_seconds").value >= 0
    MultiLayerNetwork.resume(str(tmp_path), device="cpu")
    assert mon.counter("restore_total").value == 1
    assert mon.gauge("restore_last_step").value == 4
