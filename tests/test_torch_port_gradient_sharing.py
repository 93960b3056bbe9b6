"""The port's gradient-sharing host math (`deeplearning4j_tpu_torch/
parallel/gradient_sharing.py`) against the JAX package's, on the CPU:
the encoder and its error-feedback identity (the mask is discontinuous
at τ, so the wire tensors are held equal except where |acc| lies within
a few float32 ulps of τ, and those near-ties are counted), the τ
controller, the configuration's validation, the mode and bucket
switches with JAX's environment variables, the configuration serde, the
τ trees, the bucket plan, the rs shard plan and the wire-byte
accounting, and the exchange counters on the monitor registry."""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.common.updaters import Adam as JaxAdam
from deeplearning4j_tpu.nn.conf import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxBuilder
from deeplearning4j_tpu.nn.layers import DenseLayer as JaxDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JaxOutput
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.parallel import gradient_sharing as jgs
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.nn.conf.builder import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import gradient_sharing as gs

NEAR_ULPS = 4       # |acc| this close to τ may encode either way


def jax_conf(depth=4, width=16, seed=7):
    b = JaxBuilder.builder().seed(seed).updater(JaxAdam(0.01)).list()
    for _ in range(depth):
        b = b.layer(JaxDense(n_in=width, n_out=width, activation="tanh"))
    return (b.layer(JaxOutput(n_in=width, n_out=4, activation="softmax",
                              loss="mcxent"))
            .set_input_type(JaxInputType.feed_forward(width)).build())


def nets(depth=4, width=16):
    jc = jax_conf(depth, width)
    jn = JaxNet(jc).init()
    pn = MultiLayerNetwork(MultiLayerConfiguration.from_json(jc.to_json()),
                           device="cpu")
    return jn, pn


def near_tie(acc, tau):
    """Elements whose |acc| is within NEAR_ULPS float32 ulps of τ."""
    tau = np.float32(tau)
    return np.abs(np.abs(acc) - tau) <= NEAR_ULPS * np.spacing(tau)


class TestEncoder:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_encode_leaf_matches_jax_off_the_ties(self, seed):
        rng = np.random.default_rng(seed)
        tau = np.float32(0.005)
        acc = (rng.standard_normal(4096) * 0.01).astype(np.float32)
        # plant exact ties and one-ulp neighbours of τ
        acc[:8] = tau
        acc[8:16] = -tau
        acc[16:24] = np.nextafter(tau, np.float32(0))
        acc[24:32] = np.nextafter(tau, np.float32(1))
        je, jr, js = jgs.encode_leaf(jnp.asarray(acc), jnp.float32(tau),
                                     jnp.int8)
        pe, pr, ps = gs.encode_leaf(torch.from_numpy(acc),
                                    torch.tensor(tau), torch.int8)
        je, jr = np.asarray(je), np.asarray(jr)
        ties = near_tie(acc, tau)
        off = ~ties
        assert ties.sum() >= 32
        np.testing.assert_array_equal(pe.numpy()[off], je[off])
        np.testing.assert_allclose(pr.numpy()[off], jr[off], rtol=0,
                                   atol=1e-9)
        # the identity holds on every element, ties included
        rebuilt = pe.numpy().astype(np.float32) * tau + pr.numpy()
        np.testing.assert_allclose(rebuilt, acc, rtol=0, atol=1e-8)
        assert pe.dtype == torch.int8
        assert set(np.unique(pe.numpy())) <= {-1, 0, 1}
        assert float(ps) == float(np.sum(np.abs(acc) >= tau))
        # near-ties that encoded differently, counted (none expected at
        # exact float32 inputs: both packages compare the same numbers)
        flips = int((pe.numpy()[ties] != je[ties]).sum())
        assert flips == 0, flips
        assert float(ps) == float(js)

    def test_wire_dtype(self):
        assert gs.wire_dtype(8) == torch.int8
        assert gs.wire_dtype(127) == torch.int8
        assert gs.wire_dtype(128) == torch.int16
        with pytest.raises(ValueError, match="32767"):
            gs.wire_dtype(40000)
        for n in (2, 127, 128, 32767):
            assert (torch.empty((), dtype=gs.wire_dtype(n)).element_size()
                    == np.dtype(jgs.wire_dtype(n)).itemsize)

    @pytest.mark.parametrize("tau,sp", [(1e-3, 0.5), (1e-3, 1e-5),
                                        (1e-3, 0.05), (1e-8, 0.0),
                                        (0.9, 0.7), (3e-4, 0.1),
                                        (3e-4, 1e-3)])
    def test_adapt_threshold_bit_equal(self, tau, sp):
        cfg = gs.ThresholdConfig()
        jcfg = jgs.ThresholdConfig()
        want = np.asarray(jgs.adapt_threshold(jnp.float32(tau),
                                              jnp.float32(sp), jcfg))
        got = gs.adapt_threshold(torch.tensor(np.float32(tau)),
                                 torch.tensor(np.float32(sp)), cfg)
        assert got.dtype == torch.float32
        assert np.float32(got.item()) == want

    def test_decode_scale_and_exchange_against_jax_math(self):
        """Two replicas' updates through `threshold_exchange`: the shared
        update is τ·Σenc/N, the residuals keep what was not sent, and
        the sparsity is the mean encoded fraction."""
        rng = np.random.default_rng(4)
        cfg = gs.ThresholdConfig(initial_threshold=0.01)
        tau = torch.tensor(np.float32(0.01))
        deltas = [{"0": {"W": torch.from_numpy(
            (rng.standard_normal((8, 8)) * 0.02).astype(np.float32))}}
            for _ in range(2)]
        res = [{"0": {"W": torch.zeros(8, 8)}} for _ in range(2)]
        old = [d["0"]["W"].clone() for d in deltas]
        dhat, res, new_tau, sp = gs.threshold_exchange(
            deltas, res, tau, cfg, device="cpu")
        encs = [np.where(np.abs(o.numpy()) >= 0.01, np.sign(o.numpy()), 0)
                for o in old]
        want = (encs[0] + encs[1]).astype(np.float32) * (
            np.float32(0.01) * np.float32(0.5))
        np.testing.assert_array_equal(dhat["0"]["W"].numpy(), want)
        for o, e, r in zip(old, encs, res):
            np.testing.assert_allclose(
                e.astype(np.float32) * np.float32(0.01) + r["0"]["W"].numpy(),
                o.numpy(), rtol=0, atol=1e-8)
        frac = np.float32((np.abs(old[0].numpy()) >= 0.01).sum()
                          + (np.abs(old[1].numpy()) >= 0.01).sum()) / 2 / 64
        assert float(sp) == pytest.approx(float(frac))
        assert np.float32(new_tau.item()) == np.asarray(jgs.adapt_threshold(
            jnp.float32(0.01), jnp.float32(frac), jgs.ThresholdConfig(
                initial_threshold=0.01)))


class TestConfig:
    @pytest.mark.parametrize("kw,match", [
        (dict(sparsity_target_min=0.5, sparsity_target_max=0.1), "band"),
        (dict(decay=1.5), "decay"),
        (dict(initial_threshold=2.0), "min_threshold")])
    def test_validation_matches_jax(self, kw, match):
        with pytest.raises(ValueError, match=match) as pe:
            gs.ThresholdConfig(**kw)
        with pytest.raises(ValueError) as je:
            jgs.ThresholdConfig(**kw)
        assert str(pe.value) == str(je.value)

    def test_defaults_and_from_conf(self):
        assert (dataclass_dict(gs.ThresholdConfig())
                == dataclass_dict(jgs.ThresholdConfig()))
        jn, pn = nets(2)
        pn.conf.gradient_sharing_threshold = 2e-3
        jn.conf.gradient_sharing_threshold = 2e-3
        assert (dataclass_dict(gs.ThresholdConfig.from_conf(pn.conf))
                == dataclass_dict(jgs.ThresholdConfig.from_conf(jn.conf)))


def dataclass_dict(c):
    import dataclasses
    return dataclasses.asdict(c)


class TestModeResolution:
    def test_precedence(self, monkeypatch):
        monkeypatch.delenv("DL4J_GRADIENT_SHARING", raising=False)
        _, pn = nets(2)
        conf = pn.conf
        assert gs.resolve_mode(None, conf) == "dense"
        conf.gradient_sharing = "threshold"
        assert gs.resolve_mode(None, conf) == "threshold"
        assert gs.resolve_mode("dense", conf) == "dense"
        for env, want in (("threshold", "threshold"), ("0", "dense"),
                          ("on", "threshold"), ("dense_rs", "dense_rs")):
            monkeypatch.setenv("DL4J_GRADIENT_SHARING", env)
            assert gs.resolve_mode("dense", conf) == want
            assert jgs.resolve_mode("dense", conf) == want
        monkeypatch.setenv("DL4J_GRADIENT_SHARING", "bogus")
        with pytest.raises(ValueError, match="DL4J_GRADIENT_SHARING"):
            gs.resolve_mode(None, conf)
        monkeypatch.delenv("DL4J_GRADIENT_SHARING")
        with pytest.raises(ValueError, match="gradient_sharing must be"):
            gs.resolve_mode("sparse", None)

    @pytest.mark.parametrize("env,arg,want", [
        (None, None, True), (None, False, False), ("0", True, False),
        ("yes", False, True), ("off", None, False)])
    def test_bucketed_resolution(self, monkeypatch, env, arg, want):
        if env is None:
            monkeypatch.delenv("DL4J_BUCKETED_EXCHANGE", raising=False)
        else:
            monkeypatch.setenv("DL4J_BUCKETED_EXCHANGE", env)
        assert gs.resolve_bucketed(arg) is want
        assert jgs.resolve_bucketed(arg) is want

    def test_bucketed_typo_raises(self, monkeypatch):
        monkeypatch.setenv("DL4J_BUCKETED_EXCHANGE", "maybe")
        with pytest.raises(ValueError, match="DL4J_BUCKETED_EXCHANGE"):
            gs.resolve_bucketed(None)

    def test_conf_serde_round_trip(self):
        jc = jax_conf(2)
        jc.gradient_sharing = "threshold_rs"
        jc.gradient_sharing_threshold = 2e-3
        pc = MultiLayerConfiguration.from_json(jc.to_json())
        assert pc.gradient_sharing == "threshold_rs"
        assert pc.gradient_sharing_threshold == 2e-3
        assert pc.to_dict()["gradient_sharing"] == "threshold_rs"
        gb = (ComputationGraphConfiguration.graph_builder()
              .gradient_sharing("threshold", threshold=2e-3))
        with pytest.raises(ValueError, match="dense|threshold"):
            ComputationGraphConfiguration.graph_builder().gradient_sharing(
                "sparse")
        assert gb._conf.gradient_sharing == "threshold"


class TestTauTrees:
    def test_init_coerce_ensure_restore_scalar(self):
        _, pn = nets(3)
        params = {k: l.jax_param_map() for k, l in pn.keyed()
                  if l.jax_param_map()}
        cfg = gs.ThresholdConfig(initial_threshold=2e-3)
        jcfg = jgs.ThresholdConfig(initial_threshold=2e-3)
        assert gs.init_tau_tree(params, cfg) == jgs.init_tau_tree(params,
                                                                  jcfg)
        tree = {"0": np.float32(1e-3), "2": np.float32(3e-3)}
        assert (gs.coerce_tau(tree, params.keys(), cfg)
                == jgs.coerce_tau(tree, params.keys(), jcfg))
        assert (gs.coerce_tau(np.float32(5e-4), params.keys(), cfg)
                == jgs.coerce_tau(np.float32(5e-4), params.keys(), jcfg))
        assert (gs.coerce_tau(None, params.keys(), cfg)
                == jgs.coerce_tau(None, params.keys(), jcfg))
        full = gs.init_tau_tree(params, cfg)
        full["1"] = np.float32(7e-3)
        assert gs.tau_scalar(full) == jgs.tau_scalar(full)
        assert gs.tau_scalar({}) == 0.0
        assert float(gs.ensure_tau_form(full, False, params, cfg)) == float(
            jgs.ensure_tau_form(full, False, params, jcfg))
        assert gs.ensure_tau_form(np.float32(4e-3), True, params, cfg) == \
            jgs.ensure_tau_form(jnp.float32(4e-3), True, params, jcfg)
        assert np.float32(gs.ensure_tau_form(None, False, params, cfg)) \
            == np.float32(jgs.ensure_tau_form(None, False, params, jcfg))
        got = gs.restore_tau({"0": np.asarray(np.float32(1e-3))})
        assert got == jgs.restore_tau({"0": np.asarray(np.float32(1e-3))})
        assert gs.restore_tau(np.asarray(np.float32(1e-3))) == float(
            jgs.restore_tau(np.asarray(np.float32(1e-3))))
        # a device tensor reads the same
        assert gs.tau_scalar({"0": torch.tensor(np.float32(1e-3))}) == \
            jgs.tau_scalar({"0": np.float32(1e-3)})


class TestPlans:
    @pytest.mark.parametrize("depth", [1, 2, 4])
    def test_bucket_plan_keys_match_jax(self, depth):
        jn, pn = nets(depth)
        want = [(k, list(m)) for k, m in jgs.bucket_plan(jn)]
        assert gs.bucket_plan(pn) == want

    def test_bucket_plan_without_packing(self, monkeypatch):
        monkeypatch.setenv("DL4J_SCAN_LAYERS", "0")
        jn, pn = nets(4)
        assert gs.bucket_plan(pn) == [(k, list(m))
                                      for k, m in jgs.bucket_plan(jn)]
        assert all(len(m) == 1 for _, m in gs.bucket_plan(pn))

    @pytest.mark.parametrize("n", [2, 4, 8])
    def test_rs_shard_plan(self, n):
        jn, pn = nets(3, width=64)
        params = {k: l.jax_param_map() for k, l in pn.keyed()
                  if l.jax_param_map()}
        assert gs.rs_shard_plan(params, n) == jgs.rs_shard_plan(
            jn.params, n)
        specs = {k: {p: ((None, "data") if p == "W" else (None,))
                     for p in lp} for k, lp in params.items()}
        got = gs.rs_shard_plan(params, n, specs=specs)
        assert all(got[k]["W"] and not got[k]["b"] for k in got)

    def test_rs_supported_gn(self):
        _, pn = nets(2)
        assert gs.rs_supported_gn(pn.conf)
        pn.conf.gradient_normalization = "clip_l2_per_layer"
        assert not gs.rs_supported_gn(pn.conf)
        pn.conf.gradient_normalization = "clip_elementwise_absolute_value"
        assert gs.rs_supported_gn(pn.conf)


class TestWireBytes:
    @pytest.mark.parametrize("mode", gs.MODES)
    @pytest.mark.parametrize("n", [2, 4, 200])
    def test_exchange_wire_bytes_match_jax(self, mode, n):
        jn, pn = nets(3, width=64)
        params = {k: l.jax_param_map() for k, l in pn.keyed()
                  if l.jax_param_map()}
        got = gs.exchange_wire_bytes(params, mode, n_workers=n)
        want = jgs.exchange_wire_bytes(jn.params, mode, n_workers=n)
        assert got == want
        got_bf = gs.exchange_wire_bytes(params, mode, n_workers=n,
                                        grad_dtype=torch.bfloat16)
        want_bf = jgs.exchange_wire_bytes(jn.params, mode, n_workers=n,
                                          grad_dtype=jnp.bfloat16)
        assert got_bf == want_bf

    def test_counters_on_the_registry(self):
        reg = monitor.MetricsRegistry()
        monitor.enable(registry=reg)
        try:
            gs.record_exchange("threshold", 100.0, 400.0, 3)
            gs.record_threshold_stats(1e-3, 0.25)
        finally:
            monitor.disable()
            monitor._STATE.registry = monitor.GLOBAL_REGISTRY
        text = reg.exposition()
        for name in ("gradient_exchange_bytes_total",
                     "gradient_exchange_steps_total",
                     "gradient_sharing_compression_ratio",
                     "gradient_sharing_threshold",
                     "gradient_sharing_sparsity"):
            assert name in text
        assert reg.counter("gradient_exchange_bytes_total", mode="threshold",
                           trainer="parallel").value == 300.0
        assert reg.gauge("gradient_sharing_compression_ratio",
                         trainer="parallel").value == 4.0
        # off: nothing recorded, nothing raised
        gs.record_exchange("dense", 1.0, 1.0)
