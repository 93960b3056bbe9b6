"""Diagnostics inside the exchanges (`ParallelTrainer`'s threshold,
threshold_rs and dense_rs steps run JAX's `_exchange_diag`,
`parallel/gradient_sharing.py:378-413`; averaging collects none, as
JAX's local-SGD step does not): the rows equal JAX's key for key and
value for value on the data-parallel tests' BatchNorm net; an unfired ``skip`` leaves every
bit as diagnostics off does; a fired ``skip`` (an inf learning rate)
keeps the params, the Adam moments, the error-feedback residual and τ
of the step before; and a non-finite residual alone clears its layer's
finite flag."""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.common.updaters import Adam as JAdam
from deeplearning4j_tpu.nn.conf.builder import (
    MultiLayerConfiguration as JConf,
)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.parallel import ParallelTrainer as JTrainer
from deeplearning4j_tpu_torch.parallel import ParallelTrainer
from test_torch_port_parallel_trainer import data, jmesh, mlp_conf, pmesh
from test_torch_port_parallel_trainer import port_net

MODES = {"threshold": dict(gradient_sharing="threshold"),
         "threshold_single": dict(gradient_sharing="threshold",
                                  bucketed=False),
         "threshold_rs": dict(gradient_sharing="threshold_rs"),
         "dense_rs": dict(gradient_sharing="dense_rs"),
         "averaging": dict(mode="averaging", averaging_frequency=2)}


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    for v in ("DL4J_GRADIENT_SHARING", "DL4J_BUCKETED_EXCHANGE",
              "DL4J_DIAGNOSTICS", "DL4J_SCAN_LAYERS"):
        monkeypatch.delenv(v, raising=False)


def _flat(d, p=""):
    out = {}
    if isinstance(d, dict):
        for k, v in d.items():
            out.update(_flat(v, f"{p}.{k}" if p else str(k)))
    else:
        out[p] = d
    return out


def _jax_net(diag):
    c = JConf.from_json(mlp_conf(JAdam(1e-2), depth=2).to_json())
    c.diagnostics = diag
    return JNet(c).init()


@pytest.mark.parametrize("mode", list(MODES))
def test_rows_equal_jax_s(mode):
    x, y = data(32)
    jn = _jax_net(True)
    JTrainer(jn, jmesh(), **MODES[mode]).fit(x, y, batch_size=32, epochs=2)
    pn = port_net(mlp_conf(JAdam(1e-2), depth=2), diagnostics=True)
    ParallelTrainer(pn, pmesh(), **MODES[mode]).fit(x, y, batch_size=32,
                                                    epochs=2)
    jr, pr = jn._last_diagnostics, pn._last_diagnostics
    if mode == "averaging":
        assert jr is None and pr is None
        return
    jf, pf = _flat(jr), _flat(pr)
    assert set(jf) == set(pf)
    for k, v in jf.items():
        if isinstance(v, (int, float, np.floating)):
            assert abs(float(v) - float(pf[k])) <= 1e-4 * max(
                1.0, abs(float(v))), (k, v, pf[k])
    assert pf["nonfinite"] in (0, 0.0, False)


def _snapshot(net, trainer):
    out = {k: v.clone() for k, v in net.param_table().items()}
    for lk, lst in net.updater_state.items():
        for pk, st in lst.items():
            for sk, t in st.items():
                out[f"upd/{lk}/{pk}/{sk}"] = t.clone()
    for r, tree in enumerate(trainer._res_r or []):
        for lk, lp in tree.items():
            for pk, t in lp.items():
                out[f"res{r}/{lk}/{pk}"] = t.clone()
    tau = trainer._tau
    for k, v in (tau.items() if isinstance(tau, dict) else
                 [("", tau)] if tau is not None else []):
        out[f"tau/{k}"] = torch.as_tensor(v).clone()
    return out


@pytest.mark.parametrize("mode", ["threshold", "threshold_rs", "dense_rs"])
def test_unfired_skip_is_bit_equal_to_off(mode):
    x, y = data(32)
    runs = []
    for diag in (None, "skip"):
        net = port_net(mlp_conf(JAdam(1e-2), depth=2), diagnostics=diag)
        tr = ParallelTrainer(net, pmesh(), **MODES[mode])
        tr.fit(x, y, batch_size=16, epochs=2)
        runs.append(_snapshot(net, tr))
    off, skip = runs
    assert set(off) == set(skip)
    for k in off:
        assert torch.equal(off[k], skip[k]), k


@pytest.mark.parametrize("mode", ["threshold", "threshold_rs", "dense_rs"])
def test_fired_skip_keeps_the_step_before(mode):
    x, y = data(32)
    net = port_net(mlp_conf(JAdam(1e-2), depth=2), diagnostics="skip")
    tr = ParallelTrainer(net, pmesh(), **MODES[mode])
    tr.fit(x[:16], y[:16], batch_size=16)
    before = _snapshot(net, tr)
    for layer in net.layers:
        layer.updater.learning_rate = float("inf")
    tr.fit(x[16:], y[16:], batch_size=16)
    after = _snapshot(net, tr)
    for k in before:
        assert torch.equal(before[k], after[k]), k
    rows = net._last_diagnostics
    assert rows["nonfinite"] and net._diag.skipped_total >= 1


def test_a_non_finite_residual_clears_its_layer_s_flag():
    from deeplearning4j_tpu_torch.monitor.diagnostics import (
        Diagnostics, DiagnosticsConfig)
    d = Diagnostics(DiagnosticsConfig())
    p = {"0": {"W": torch.ones(2, 2)}, "1": {"W": torch.ones(2)}}
    old = {k: {n: t.clone() for n, t in lp.items()} for k, lp in p.items()}
    res = [{"0": {"W": torch.zeros(2, 2)}, "1": {"W": torch.zeros(2)}},
           {"0": {"W": torch.zeros(2, 2)},
            "1": {"W": torch.tensor([0.0, float("nan")])}}]
    v, ok = d.collect("exchange", params_new=p, params_old=old,
                      loss=torch.tensor(1.0), extra_finite=res)
    rows = dict(zip([k for k, _ in d.layouts["exchange"]], v.tolist()))
    assert rows["finite.0"] == 1.0 and rows["finite.1"] == 0.0
    assert not bool(ok) and rows["nonfinite"] == 1.0
