"""The port's in-step diagnostics and watchdog (`deeplearning4j_tpu_torch/
monitor/diagnostics.py`, `nn/container.py`) held against the JAX
package's (`deeplearning4j_tpu/monitor/diagnostics.py`), on the CPU.

- one step's `_last_diagnostics` of the same MLP (same seeded params and
  data, a packed run of three Dense layers) has JAX's keys and values
  within JAX's own test tolerance (rtol 2e-4);
- JAX's TestBitParity, TestWatchdog, TestTransferContract and
  TestResolutionAndSerde (tests/test_diagnostics.py) mirrored on the
  port: diagnostics on (warn, or a skip that never fires) leave params
  and Adam's m and v bit-equal to diagnostics off, for the MLP, spe 3, a
  deep stack, mixed_bf16, a graph and a 2-block TransformerLM through
  the kernels' plain versions;
- the skip gate puts back p, m, v and the running state bit for bit;
- a JAX `configuration.json` with `diagnostics` trains in the port, and
  a checkpoint trained with diagnostics resumes.
"""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import json

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.layers import DenseLayer as JaxDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JaxOutput
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu_torch import fault, monitor
from deeplearning4j_tpu_torch.common.schedules import MapSchedule
from deeplearning4j_tpu_torch.common.updaters import Adam
from deeplearning4j_tpu_torch.monitor.diagnostics import (
    DiagnosticsConfig,
    NonFiniteGradientsError,
    as_diagnostics,
    resolve_diagnostics,
)
from deeplearning4j_tpu_torch.monitor.registry import MetricsRegistry
from deeplearning4j_tpu_torch.nn.conf.builder import (
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph,
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers import (
    BatchNormalization,
    DenseLayer,
    OutputLayer,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.zoo.transformer import TransformerLM

STATS_RTOL = 2e-4      # JAX's own packed-vs-unrolled stats tolerance


def _mlp_conf(depth=3, diagnostics=None, scan_layers=True, policy=None,
              updater=None, nnc=NeuralNetConfiguration, dense=DenseLayer,
              output=OutputLayer):
    b = nnc.builder().seed(7)
    if updater is not None:
        b = b.updater(updater)
    if policy is not None:
        b = b.dtype_policy(policy)
    lb = b.list()
    for _ in range(depth):
        lb = lb.layer(dense(n_in=8, n_out=8, activation="tanh"))
    lb = lb.layer(output(n_in=8, n_out=3, activation="softmax",
                         loss="mcxent"))
    lb = lb.scan_layers(scan_layers)
    if diagnostics is not None:
        lb = lb.diagnostics(diagnostics)
    return lb.build()


def _net(**kw):
    return MultiLayerNetwork(_mlp_conf(**kw), device="cpu").init()


def _data(n=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 8)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


def _tensors(net):
    """Every param and updater-state tensor, in a fixed order."""
    out = [t for _, t in sorted(net.param_table().items())]
    for lk in sorted(net.updater_state):
        for pk in sorted(net.updater_state[lk]):
            st = net.updater_state[lk][pk]
            out += [st[k] for k in sorted(st)]
    return out


def _bit_equal(a, b, equal_nan=False):
    return all(torch.equal(u, v) if not equal_nan else
               bool(torch.all((u == v) | (torch.isnan(u) & torch.isnan(v))))
               for u, v in zip(_tensors(a), _tensors(b)))


def _poisoned():
    x, y = _data(24)
    xb = x.copy()
    xb[8:16] = np.inf      # the second batch is not finite
    return xb, y


@pytest.fixture
def registry():
    reg = MetricsRegistry()
    monitor.enable(registry=reg)
    yield reg
    monitor.disable()


def _d2h(reg):
    return reg.counter("jax_transfers_total", direction="d2h").value


# ------------------------------------------------------------ vs JAX
def test_one_step_stats_match_jax():
    """One step of the same MLP (a three-layer packed run) in both
    packages: the same key set, each value within rtol 2e-4."""
    jconf = _mlp_conf(diagnostics="warn", nnc=JaxNNC, dense=JaxDense,
                      output=JaxOutput)
    x, y = _data(8)
    jnet = JaxNet(jconf).init()
    jnet.fit(x, y, epochs=1, batch_size=8, shuffle=False)
    # the port's net from JAX's configuration.json, diagnostics included
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    assert conf.diagnostics == DiagnosticsConfig(watchdog="warn")
    net = MultiLayerNetwork(conf, device="cpu").init()
    net.fit(x, y, epochs=1, batch_size=8, shuffle=False)
    want, got = jnet._last_diagnostics, net._last_diagnostics
    assert got["finite"] == want["finite"]
    assert got["nonfinite"] == want["nonfinite"] is False
    for part in ("params", "activations"):
        assert set(got[part]) == set(want[part]), part
        for key, st in want[part].items():
            assert set(got[part][key]) == set(st), (part, key)
            for name, v in st.items():
                np.testing.assert_allclose(got[part][key][name], v,
                                           rtol=STATS_RTOL, atol=1e-7,
                                           err_msg=f"{part} {key} {name}")


# --------------------------------------------------------- bit parity
@pytest.mark.parametrize("case", ["plain", "spe3", "deep", "mixed_bf16",
                                  "skip_healthy", "histograms"])
def test_bit_parity_mlp(case):
    """Diagnostics on leave params and Adam's m and v bit-equal to off."""
    kw = {"deep": dict(depth=6), "mixed_bf16": dict(policy="mixed_bf16")
          }.get(case, {})
    spec = {"skip_healthy": "skip",
            "histograms": DiagnosticsConfig(histograms=True,
                                            histogram_bins=8,
                                            histogram_range=2.0)
            }.get(case, "warn")
    fit = dict(epochs=2, batch_size=8, shuffle=False,
               steps_per_execution=3 if case == "spe3" else 1)
    x, y = _data(48 if case == "spe3" else 32)
    off = _net(updater=Adam(0.01), **kw)
    off.fit(x, y, **fit)
    on = _net(updater=Adam(0.01), diagnostics=spec, **kw)
    on.fit(x, y, **fit)
    assert _bit_equal(off, on)
    d = on._last_diagnostics
    assert set(d["params"]["0_W"]) == {
        "grad_mm", "grad_l2", "upd_mm", "upd_l2", "param_mm", "param_l2",
        "ratio"}
    assert not d["nonfinite"] and on._diag.skipped_total == 0
    assert set(d["params"]) == {f"{i}_{p}" for i in range(len(on.layers))
                                for p in ("W", "b")}
    assert set(d["activations"]) == {str(i)
                                     for i in range(len(on.layers) - 1)}
    if case == "mixed_bf16":
        st = d["params"]["0_W"]
        assert st["grad_l2"] > 0 and np.isfinite(st["ratio"])
    if case == "histograms":
        h = d["hists"]["0_W"]
        assert len(h) == 8 and float(np.sum(h)) == 64.0


def _graph(diag=None, bn=False):
    gb = (ComputationGraphConfiguration.graph_builder(
        NeuralNetConfiguration.builder().seed(3).updater(Adam(0.01)))
        .add_inputs("in"))
    prev = "in"
    for i in range(3):
        gb.add_layer(f"d{i}", DenseLayer(n_in=8, n_out=8, activation="tanh"),
                     prev)
        prev = f"d{i}"
    if bn:
        gb.add_layer("bn", BatchNormalization(n_out=8), prev)
        prev = "bn"
    gb.add_layer("out", OutputLayer(n_in=8, n_out=3, activation="softmax",
                                    loss="mcxent"), prev)
    gb.set_outputs("out")
    if diag is not None:
        gb.diagnostics(diag)
    return ComputationGraph(gb.build(), device="cpu").init()


def test_bit_parity_graph():
    x, y = _data()
    off = _graph()
    off.fit(x, y, epochs=1, batch_size=8, steps_per_execution=2)
    on = _graph("warn")
    on.fit(x, y, epochs=1, batch_size=8, steps_per_execution=2)
    assert _bit_equal(off, on)
    assert "d1_W" in on._last_diagnostics["params"]
    assert set(on._last_diagnostics["activations"]) == {"d0", "d1", "d2"}


LM = dict(vocab_size=32, d_model=32, n_layers=2, n_heads=2, max_len=16)


def _lm_data(n=4, seed=5):
    seq = np.random.default_rng(seed).integers(0, LM["vocab_size"],
                                               (n, LM["max_len"]))
    return (seq[:, :-1].astype(np.float32),
            np.eye(LM["vocab_size"], dtype=np.float32)[seq[:, 1:]])


@pytest.mark.parametrize("policy", [None, "mixed_bf16"])
def test_bit_parity_lm_and_remat_adds_no_stats(policy):
    """The 2-block TransformerLM (LayerNorm, flash attention and fused
    Adam through their plain versions): skip that never fires is
    bit-equal to off; under full remat the stats are the same numbers
    with the same keys (the recompute adds none)."""
    x, y = _lm_data()
    off = TransformerLM(**LM).init(device="cpu", dtype_policy=policy)
    off.fit(x, y, batch_size=2, shuffle=False)
    on = TransformerLM(**LM).init(device="cpu", dtype_policy=policy,
                                  diagnostics="skip")
    on.fit(x, y, batch_size=2, shuffle=False)
    assert _bit_equal(off, on)
    remat = TransformerLM(**LM, remat=True).init(
        device="cpu", dtype_policy=policy, diagnostics="skip")
    remat.fit(x, y, batch_size=2, shuffle=False)
    assert _bit_equal(on, remat)
    a, b = on._last_diagnostics, remat._last_diagnostics
    assert set(a["activations"]) == set(b["activations"]) == {
        str(i) for i in range(LM["n_layers"] + 2)}
    assert a == b


# ----------------------------------------------------------- watchdog
def test_warn_counts_and_preserves_trajectory():
    xb, y = _poisoned()
    plain = _net()
    plain.fit(xb, y, epochs=1, batch_size=8, shuffle=False)
    warn = _net(diagnostics="warn")
    warn.fit(xb, y, epochs=1, batch_size=8, shuffle=False)
    assert _bit_equal(plain, warn, equal_nan=True)
    assert warn._diag.nonfinite_total >= 1
    assert warn._diag.skipped_total == 0


@pytest.mark.parametrize("spe", [1, 3])
def test_skip_discards_on_the_device_and_counts(spe):
    xb, y = _poisoned()
    net = _net(diagnostics="skip", updater=Adam(0.01))
    net.fit(xb, y, epochs=1, batch_size=8, shuffle=False,
            steps_per_execution=spe)
    assert all(bool(torch.isfinite(t).all()) for t in _tensors(net))
    assert net._diag.skipped_total == 1 and net._diag.nonfinite_total == 1


def test_skip_restores_params_moments_and_running_state():
    """An inf learning rate at iteration 1 (finite gradients, a
    non-finite update): after it, p, m, v and BatchNormalization's
    running state are bitwise what they were after step 0; the bias
    correction moves on with the iteration count, as in JAX."""
    x, y = _data(24)
    lr = MapSchedule({0: 0.01, 1: float("inf"), 2: 0.01})

    def build():
        net = _graph("skip", bn=True)
        for layer in net.layers:
            layer.updater = Adam(lr)
        return net
    net = build()
    net.fit(x[:8], y[:8], batch_size=8)
    before = [t.clone() for t in _tensors(net)] + [
        t.clone() for st in net.net_state.values() for t in st.values()]
    net.fit(x[8:16], y[8:16], batch_size=8)
    after = _tensors(net) + [t for st in net.net_state.values()
                             for t in st.values()]
    assert all(torch.equal(u, v) for u, v in zip(before, after))
    assert net._last_diagnostics["nonfinite"]
    assert not net._last_diagnostics["finite"]["d0"]
    assert net._last_diagnostics["finite"]["<loss>"]
    assert net.iteration_count == 2 and net._diag.skipped_total == 1
    net.fit(x[16:], y[16:], batch_size=8)
    assert all(bool(torch.isfinite(t).all()) for t in _tensors(net))


def test_halt_raises_with_layer_keys_and_records_it():
    from deeplearning4j_tpu_torch.monitor.flightrec import (
        GLOBAL_FLIGHT_RECORDER)
    xb, y = _poisoned()
    net = _net(diagnostics="halt")
    with pytest.raises(NonFiniteGradientsError) as ei:
        net.fit(xb, y, epochs=1, batch_size=8, shuffle=False)
    assert ei.value.iteration == 1
    assert ei.value.layer_keys
    ev = GLOBAL_FLIGHT_RECORDER.events(kind="watchdog_halt", last=1)[0]
    assert ev["iteration"] == 1 and ev["layers"] == ei.value.layer_keys


def test_watchdog_registry_counters(registry):
    xb, y = _poisoned()
    net = _net(diagnostics="skip")
    net.fit(xb, y, epochs=1, batch_size=8, shuffle=False)
    assert registry.counter("watchdog_nonfinite_total").value == 1
    assert registry.counter("watchdog_skipped_total").value == 1
    text = registry.exposition()
    assert "watchdog_nonfinite_total 1" in text
    assert 'training_update_ratio{param="0_W"}' in text


# --------------------------------------------------- transfer contract
@pytest.mark.parametrize("case,want", [("cadence2", 2), ("spe3", 2),
                                       ("off", 0)])
def test_transfer_contract(registry, case, want):
    """One batched d2h copy per report: report_frequency 2 over 4 steps
    reads 2; spe 3 over 6 steps reads once a group; diagnostics off
    read nothing."""
    spec = {"cadence2": DiagnosticsConfig(report_frequency=2),
            "spe3": True}.get(case)
    x, y = _data(48 if case == "spe3" else 32)
    net = _net(diagnostics=spec)
    before = _d2h(registry)
    net.fit(x, y, epochs=1, batch_size=8, shuffle=False,
            steps_per_execution=3 if case == "spe3" else 1)
    assert _d2h(registry) - before == want


# --------------------------------------------------- resolution + serde
def test_as_diagnostics_forms():
    assert as_diagnostics(None) is None
    assert as_diagnostics(False) is None
    assert as_diagnostics("off") is None
    assert as_diagnostics(True) == DiagnosticsConfig()
    assert as_diagnostics("skip").watchdog == "skip"
    cfg = DiagnosticsConfig(histograms=True)
    assert as_diagnostics(cfg) is cfg
    assert as_diagnostics(cfg.to_dict()) == cfg
    with pytest.raises(ValueError):
        as_diagnostics("bogus")
    with pytest.raises(ValueError):
        DiagnosticsConfig(watchdog="explode")


def test_env_overrides_and_arg_beats_conf(monkeypatch):
    conf = _mlp_conf(diagnostics="warn")
    assert resolve_diagnostics(None, conf).watchdog == "warn"
    assert MultiLayerNetwork(conf, device="cpu",
                             diagnostics="skip").diagnostics.watchdog == "skip"
    assert MultiLayerNetwork(conf, device="cpu").diagnostics.watchdog == "warn"
    gconf = _graph("warn").conf
    assert ComputationGraph(gconf, device="cpu",
                            diagnostics="halt").diagnostics.watchdog == "halt"
    assert ComputationGraph(gconf, device="cpu").diagnostics.watchdog == "warn"
    monkeypatch.setenv("DL4J_DIAGNOSTICS", "0")
    assert resolve_diagnostics("skip", conf) is None
    monkeypatch.setenv("DL4J_DIAGNOSTICS", "halt")
    assert resolve_diagnostics(None, conf).watchdog == "halt"
    monkeypatch.setenv("DL4J_DIAGNOSTICS", "sideways")
    with pytest.raises(ValueError):
        resolve_diagnostics(None, conf)


def test_serde_round_trips_and_matches_jax():
    cfg = DiagnosticsConfig(watchdog="skip", histograms=True,
                            report_frequency=5)
    conf = _mlp_conf(diagnostics=cfg)
    rt = MultiLayerConfiguration.from_dict(conf.to_dict())
    assert rt.diagnostics == conf.diagnostics
    jconf = _mlp_conf(diagnostics=cfg.to_dict(), nnc=JaxNNC,
                      dense=JaxDense, output=JaxOutput)
    assert (json.loads(conf.to_json())["diagnostics"]
            == json.loads(jconf.to_json())["diagnostics"])
    assert MultiLayerConfiguration.from_dict(
        _mlp_conf().to_dict()).diagnostics is None
    gb = (ComputationGraphConfiguration.graph_builder(
        NeuralNetConfiguration.builder()).add_inputs("in"))
    gb.add_layer("d", DenseLayer(n_in=4, n_out=4), "in")
    gb.add_layer("out", OutputLayer(n_in=4, n_out=2), "d")
    gb.set_outputs("out").diagnostics("halt")
    grt = ComputationGraphConfiguration.from_dict(gb.build().to_dict())
    assert grt.diagnostics.watchdog == "halt"


def test_checkpoint_keeps_the_active_config_and_resumes(tmp_path):
    """An argument-chosen watchdog survives the checkpoint meta (JAX's
    `fault/state.py:177, 219`), and a run trained with diagnostics
    resumes bit-equal to the uninterrupted one."""
    from deeplearning4j_tpu_torch.fault import state as fs
    net = MultiLayerNetwork(_mlp_conf(), device="cpu",
                            diagnostics="skip").init()
    assert fs.build_model(fs.capture_training_state(net)["meta"],
                          device="cpu").diagnostics.watchdog == "skip"
    plain = _net()
    assert fs.build_model(fs.capture_training_state(plain)["meta"],
                          device="cpu").diagnostics is None
    x, y = _data(32)
    ref = _net(diagnostics="warn")
    ref.fit(x, y, epochs=2, batch_size=8, shuffle=False)
    run = _net(diagnostics="warn")
    ck = fault.AsyncCheckpointer(str(tmp_path), keep_last=2)
    run.add_listener(fault.CheckpointListener(ck, frequency=4))
    run.fit(x, y, epochs=1, batch_size=8, shuffle=False)
    ck.wait()
    back = MultiLayerNetwork.resume(str(tmp_path), device="cpu")
    assert back.diagnostics == DiagnosticsConfig(watchdog="warn")
    back.fit(x, y, epochs=1, batch_size=8, shuffle=False)
    assert _bit_equal(ref, back)


def test_phase_15_small_mode_on_the_cpu():
    """chip_smoke.py's phase 15 at small sizes on the CPU: every check
    but the launch counts (0 on the CPU) holds."""
    import chip_smoke
    fails = chip_smoke.Failures()
    report = {}
    chip_smoke.phase_telemetry(torch.device("cpu"), report, fails,
                               small=True)
    assert list(fails) == [], list(fails)
    lm = report["telemetry"]["lm"]["float32"]
    assert lm["parity"]["bit_equal"] and lm["poison"]["skip_unchanged"]
    assert lm["transfers"]["d2h_cadence"] == 3
