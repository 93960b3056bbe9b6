"""The port's ModelRegistry against the JAX package's
(`tests/test_serving_fleet.py::TestModelRegistry`): every registry case
of the JAX suite on the port, the publish listener at step boundaries
(steps_per_execution 2) and on its wall clock, each beside the JAX
listener's publishes of the same run, and the store as the bridge
between the packages: a root written by one resolves in the other with
`output()` within 1e-5, and one scripted sequence of publishes, pins,
unpins and collections leaves the same files in both."""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import logging
import os
import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.serving import ModelRegistry as JaxRegistry
from deeplearning4j_tpu_torch.fault.errors import CheckpointCorruptError
from deeplearning4j_tpu_torch.serving import (
    ModelRegistry,
    RegistryPublishListener,
    VersionConflictError,
)
from torch_port_fleet import jax_mlp, params_equal, port_mlp

OUTPUT_ATOL = 1e-5


def _corrupt(path, offset_frac=0.5, n=64):
    data = bytearray(path.read_bytes())
    mid = int(len(data) * offset_frac)
    for i in range(mid, min(mid + n, len(data))):
        data[i] ^= 0xFF
    path.write_bytes(data)


def _x(n=4, seed=0):
    return np.random.default_rng(seed).standard_normal((n, 4)).astype(
        np.float32)


def _out(net, x):
    return net.output(x).detach().cpu().numpy()


def _listing(root):
    """Every file under `root`, relative, sorted."""
    out = []
    for d, _, files in os.walk(root):
        for f in files:
            out.append(os.path.relpath(os.path.join(d, f), root))
    return sorted(out)


class TestModelRegistry:
    def test_publish_resolve_roundtrip(self, tmp_path):
        reg = ModelRegistry(tmp_path)
        net = port_mlp()
        assert reg.publish("mlp", net) == 1
        assert reg.versions("mlp") == [1] and reg.models() == ["mlp"]
        restored, rv = reg.resolve("mlp", device="cpu")
        assert rv == 1 and params_equal(restored, net)
        np.testing.assert_allclose(_out(restored, _x()), _out(net, _x()),
                                   rtol=1e-6)

    def test_auto_versions_monotonic(self, tmp_path):
        reg = ModelRegistry(tmp_path)
        net = port_mlp()
        assert [reg.publish("m", net) for _ in range(3)] == [1, 2, 3]
        assert reg.latest("m") == 3

    def test_explicit_version_conflict_one_winner(self, tmp_path):
        reg = ModelRegistry(tmp_path)
        a, b = port_mlp(seed=1), port_mlp(seed=2)
        reg.publish("m", a, version=7)
        with pytest.raises(VersionConflictError, match="v7"):
            reg.publish("m", b, version=7)
        restored, _ = reg.resolve("m", 7, device="cpu")
        assert params_equal(restored, a) and not params_equal(restored, b)

    def test_concurrent_same_version_exactly_one_winner(self, tmp_path):
        reg = ModelRegistry(tmp_path)
        nets = [port_mlp(seed=s) for s in (1, 2, 3, 4)]
        outcomes = [None] * 4
        barrier = threading.Barrier(4)

        def pub(i):
            barrier.wait()
            try:
                reg.publish("m", nets[i], version=5)
                outcomes[i] = "won"
            except VersionConflictError:
                outcomes[i] = "lost"
            except Exception as e:  # noqa: BLE001 — any other end of a
                # loser breaks the one-winner contract
                outcomes[i] = f"crashed: {e!r}"

        threads = [threading.Thread(target=pub, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert outcomes.count("won") == 1, outcomes
        assert outcomes.count("lost") == 3, outcomes
        restored, _ = reg.resolve("m", 5, device="cpu")
        assert params_equal(restored, nets[outcomes.index("won")])
        assert not list(reg.model_dir("m").glob(".publish-*"))

    def test_corrupt_latest_falls_back_with_warning(self, tmp_path,
                                                    caplog):
        from deeplearning4j_tpu_torch import monitor
        from deeplearning4j_tpu_torch.monitor.registry import MetricsRegistry
        mreg = monitor.enable(registry=MetricsRegistry())
        try:
            reg = ModelRegistry(tmp_path)
            a, b = port_mlp(seed=1), port_mlp(seed=2)
            reg.publish("m", a)
            reg.publish("m", b)
            _corrupt(reg.path("m", 2))
            with caplog.at_level(
                    logging.WARNING,
                    logger="deeplearning4j_tpu_torch.serving.registry"):
                restored, v = reg.resolve("m", device="cpu")
            snap = mreg.snapshot()
        finally:
            monitor.disable()
        assert v == 1 and params_equal(restored, a)
        assert any("corrupt" in r.message and "falling back" in r.message
                   for r in caplog.records)
        assert snap["registry_resolve_fallback_total"]["values"][0][
            "value"] == 1
        assert snap["registry_published_total"]["values"][0]["value"] == 2

    def test_explicit_corrupt_version_raises(self, tmp_path):
        reg = ModelRegistry(tmp_path)
        reg.publish("m", port_mlp(seed=1))
        reg.publish("m", port_mlp(seed=2))
        _corrupt(reg.path("m", 2))
        with pytest.raises(CheckpointCorruptError):
            reg.resolve("m", 2, device="cpu")
        assert reg.resolve("m", device="cpu")[1] == 1

    def test_all_corrupt_raises_naming_candidates(self, tmp_path):
        reg = ModelRegistry(tmp_path)
        reg.publish("m", port_mlp(seed=1))
        reg.publish("m", port_mlp(seed=2))
        _corrupt(reg.path("m", 1))
        _corrupt(reg.path("m", 2))
        with pytest.raises(CheckpointCorruptError) as ei:
            reg.resolve("m", device="cpu")
        assert "v1" in str(ei.value) and "v2" in str(ei.value)

    def test_retention_keep_last_and_keep_every(self, tmp_path):
        reg = ModelRegistry(tmp_path, keep_last=2, keep_every=3)
        net = port_mlp()
        for _ in range(7):
            reg.publish("m", net)
        assert reg.versions("m") == [3, 6, 7]

    def test_retention_never_deletes_pinned(self, tmp_path):
        reg = ModelRegistry(tmp_path, keep_last=1)
        net = port_mlp()
        reg.publish("m", net)
        reg.pin("m", 1)
        for _ in range(4):
            reg.publish("m", net)
        assert reg.versions("m") == [1, 5]
        reg.unpin("m", 1)
        assert reg.versions("m") == [5]

    def test_pin_markers_protect_across_registry_instances(self,
                                                           tmp_path):
        serving = ModelRegistry(tmp_path, keep_last=1)
        net = port_mlp()
        serving.publish("m", net)
        serving.pin("m", 1)
        trainer = ModelRegistry(tmp_path, keep_last=1)
        for _ in range(3):
            trainer.publish("m", net)
        assert 1 in trainer.versions("m")
        serving.unpin("m", 1)
        trainer.publish("m", net)
        assert 1 not in trainer.versions("m")

    def test_stale_pin_marker_from_dead_pid_is_swept(self, tmp_path):
        reg = ModelRegistry(tmp_path, keep_last=1)
        net = port_mlp()
        reg.publish("m", net)
        (reg.model_dir("m") / ".pin-v1.999999999").touch()
        for _ in range(2):
            reg.publish("m", net)
        assert reg.versions("m") == [3]
        assert not list(reg.model_dir("m").glob(".pin-v1.*"))

    def test_resolve_missing(self, tmp_path):
        reg = ModelRegistry(tmp_path)
        with pytest.raises(FileNotFoundError, match="no published"):
            reg.resolve("ghost", device="cpu")
        reg.publish("m", port_mlp())
        with pytest.raises(FileNotFoundError, match="v9"):
            reg.resolve("m", 9, device="cpu")
        with pytest.raises(ValueError, match="invalid model name"):
            reg.publish("../escape", port_mlp())

    def test_resolve_defaults_to_the_card(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("checks the refusal on a machine without CUDA")
        reg = ModelRegistry(tmp_path)
        reg.publish("m", port_mlp())
        with pytest.raises(RuntimeError, match="CUDA"):
            reg.resolve("m")


class TestPublishListener:
    def test_checkpoint_as_publish(self, tmp_path):
        reg = ModelRegistry(tmp_path)
        net = port_mlp()
        listener = reg.publish_listener("mlp", frequency=4)
        assert isinstance(listener, RegistryPublishListener)
        net.add_listener(listener)
        rng = np.random.default_rng(0)
        x = rng.standard_normal((32, 4)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 32)]
        net.fit(x, y, epochs=1, batch_size=4)            # 8 steps
        assert listener.published_steps == [4, 8]
        restored, v = reg.resolve("mlp", device="cpu")
        assert v == reg.latest("mlp") == 2
        assert params_equal(restored, net)

    def test_step_boundaries_match_jax_at_spe_2(self, tmp_path):
        """steps_per_execution 2: only a group's last callback is a step
        boundary, so frequency 3 publishes at 4 and 8 (and at fit end
        when off cadence) in both packages."""
        rng = np.random.default_rng(1)
        x = rng.standard_normal((40, 4)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 40)]
        steps = {}
        for tag, reg, net in (
                ("jax", JaxRegistry(tmp_path / "jax"), jax_mlp()),
                ("port", ModelRegistry(tmp_path / "port"), port_mlp())):
            listener = reg.publish_listener("mlp", frequency=3)
            net.add_listener(listener)
            net.fit(x, y, epochs=1, batch_size=4, steps_per_execution=2,
                    shuffle=False)
            steps[tag] = (listener.published_steps,
                          listener.published_versions,
                          reg.versions("mlp"))
        assert steps["port"] == steps["jax"]
        assert steps["port"][0] == [4, 8, 10]

    def test_every_s_clock_matches_jax(self, tmp_path):
        """The wall-clock cadence: the clock anchors at fit start, a
        boundary publishes once `every_s` has passed (the anchor is moved
        back by `every_s` to stand for that wait), and only a publish
        moves the clock on. Driven the same way in both packages."""
        steps = {}
        for tag, reg, net in (
                ("jax", JaxRegistry(tmp_path / "jax"), jax_mlp()),
                ("port", ModelRegistry(tmp_path / "port"), port_mlp())):
            listener = reg.publish_listener("mlp", frequency=100,
                                            every_s=30.0)
            listener.on_fit_start(net)
            for it in range(6):
                if it == 2:
                    listener._last_published_time -= 30.0
                listener.iteration_done(net, it, 0, 0.0,
                                        step_boundary=True)
            net.iteration_count = 6
            listener.on_fit_end(net)
            steps[tag] = listener.published_steps
        assert steps["port"] == steps["jax"] == [3, 6]
        with pytest.raises(ValueError, match="every_s"):
            ModelRegistry(tmp_path / "x").publish_listener("m", every_s=0)


class TestAcrossPackages:
    def test_jax_publishes_port_resolves_and_back(self, tmp_path):
        x = _x(6, seed=3)
        jreg, preg = JaxRegistry(tmp_path), ModelRegistry(tmp_path)
        jnet = jax_mlp(seed=11)
        assert jreg.publish("mlp", jnet) == 1
        pnet, v = preg.resolve("mlp", device="cpu")
        assert v == 1
        np.testing.assert_allclose(_out(pnet, x),
                                   np.asarray(jnet.output(x)),
                                   atol=OUTPUT_ATOL, rtol=0)
        # the port publishes the next version of the same model
        pnet2 = port_mlp(seed=12)
        assert preg.publish("mlp", pnet2) == 2
        jnet2, v2 = jreg.resolve("mlp")
        assert v2 == 2
        np.testing.assert_allclose(np.asarray(jnet2.output(x)),
                                   _out(pnet2, x), atol=OUTPUT_ATOL,
                                   rtol=0)

    def test_same_operations_leave_the_same_files(self, tmp_path):
        """One script of publishes, pins, a forged stale marker, unpins
        and the collections they trigger, run against a JAX registry
        and a port registry: the same sorted listing of each root."""
        def script(reg, net):
            for _ in range(3):
                reg.publish("a", net)
            reg.pin("a", 1)
            (reg.model_dir("a") / ".pin-v2.999999999").touch()
            for _ in range(3):
                reg.publish("a", net)
            reg.publish("b", net, version=4)
            reg.pin("b", 4)
            for _ in range(4):
                reg.publish("b", net)
            reg.unpin("a", 1)
            reg.publish("a", net)
            return reg.models(), reg.versions("a"), reg.versions("b")

        got = {}
        for tag, cls, net in (("jax", JaxRegistry, jax_mlp()),
                              ("port", ModelRegistry, port_mlp())):
            root = tmp_path / tag
            got[tag] = (script(cls(root, keep_last=2, keep_every=3), net),
                        _listing(root))
        assert got["port"] == got["jax"]
        (models, va, vb), files = got["port"]
        assert models == ["a", "b"] and va == [3, 6, 7] and \
            vb == [4, 6, 7, 8]
        assert f"b/.pin-v4.{os.getpid()}" in files
