"""The port's `ParallelInference` (`deeplearning4j_tpu_torch/parallel/
inference.py`) against the JAX package's on a 4-way CPU mesh: outputs
against the model's and JAX's, power-of-two bucket padding times the
data axis, coalescing of concurrent callers (the executed batch sizes),
`output_batched`, start/stop/shutdown with every pending Future failed,
errors reaching every caller, and the latency, queue and batch-size
metrics with no device sync."""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.common.updaters import Adam as JaxAdam
from deeplearning4j_tpu.nn.conf import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxBuilder
from deeplearning4j_tpu.nn.layers import DenseLayer as JaxDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JaxOutput
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.parallel import MeshSpec as JaxMeshSpec
from deeplearning4j_tpu.parallel import ParallelInference as JaxPI
from deeplearning4j_tpu.parallel import make_mesh as jax_make_mesh
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.nn.conf.builder import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import (
    MeshSpec,
    ParallelInference,
    make_mesh,
)

ATOL = 1e-5


def jconf():
    return (JaxBuilder.builder().seed(42).updater(JaxAdam(0.02)).list()
            .layer(JaxDense(n_in=4, n_out=16, activation="relu"))
            .layer(JaxOutput(n_in=16, n_out=3, activation="softmax",
                             loss="mcxent"))
            .set_input_type(JaxInputType.feed_forward(4)).build())


@pytest.fixture(scope="module")
def nets():
    jn = JaxNet(jconf()).init()
    pn = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf().to_json()), device="cpu").init()
    return jn, pn


def pmesh(n=4):
    return make_mesh(MeshSpec.of(data=n), devices=["cpu"] * n)


def xs(n, seed=0):
    return np.random.default_rng(seed).standard_normal((n, 4)).astype(
        np.float32)


@pytest.mark.parametrize("n", [1, 3, 4, 13, 64, 300])
def test_output_matches_model_and_jax(nets, n):
    jn, pn = nets
    x = xs(n)
    pi = ParallelInference(pn, pmesh())
    got = pi.output(x)
    assert got.shape == (n, 3)
    np.testing.assert_allclose(got, pn.output(x).numpy(), atol=ATOL)
    jpi = JaxPI(jn, jax_make_mesh(JaxMeshSpec.of(data=4)))
    np.testing.assert_allclose(got, jpi.output(x), atol=ATOL)


@pytest.mark.parametrize("n,want", [(1, 4), (3, 4), (5, 8), (17, 32),
                                    (256, 256), (300, 300), (301, 304)])
def test_bucket_padding_is_jax(nets, n, want):
    jn, pn = nets
    assert ParallelInference(pn, pmesh())._bucket(n) == want
    assert JaxPI(jn, jax_make_mesh(JaxMeshSpec.of(data=4)))._bucket(n) == want


def test_batched_requests(nets):
    _, pn = nets
    pi = ParallelInference(pn, pmesh())
    reqs = [xs(k, seed=k) for k in (1, 5, 2)]
    outs = pi.output_batched(reqs)
    assert [o.shape[0] for o in outs] == [1, 5, 2]
    for r, o in zip(reqs, outs):
        np.testing.assert_allclose(o, pn.output(r).numpy(), atol=ATOL)


def test_concurrent_callers_coalesced(nets):
    _, pn = nets
    pi = ParallelInference(pn, pmesh(), batch_limit=64,
                           queue_limit_ms=200.0).start()
    try:
        reqs = [xs(1, seed=i) for i in range(16)]
        futs, barrier = [None] * 16, threading.Barrier(16)

        def call(i):
            barrier.wait()
            futs[i] = pi.output_async(reqs[i])

        th = [threading.Thread(target=call, args=(i,)) for i in range(16)]
        for t in th:
            t.start()
        for t in th:
            t.join()
        outs = [f.result(timeout=10) for f in futs]
    finally:
        pi.stop()
    for r, o in zip(reqs, outs):
        np.testing.assert_allclose(o, pn.output(r).numpy(), atol=ATOL)
    assert sum(pi.batch_size_history) == 16
    assert max(pi.batch_size_history) > 1       # coalesced


def test_lifecycle_and_errors(nets):
    _, pn = nets
    pi = ParallelInference(pn, pmesh())
    with pytest.raises(RuntimeError, match="start"):
        pi.output_async(xs(1))
    with pi:
        bad = pi.output_async(np.zeros((2, 7), np.float32))
        with pytest.raises(Exception):
            bad.result(timeout=10)
        ok = pi.output_async(xs(2))
        assert ok.result(timeout=10).shape == (2, 3)
    pi.start()
    pi.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        pi.output_async(xs(1))
    with pytest.raises(RuntimeError, match="shut down"):
        pi.start()


def test_stop_fails_pending(nets):
    _, pn = nets
    pi = ParallelInference(pn, pmesh())
    pi._running = True              # enqueue with no collector running
    fut = pi.output_async(xs(1))
    pi._running = False
    pi.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        fut.result(timeout=1)


def test_metrics_without_device_sync(nets, monkeypatch):
    _, pn = nets
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: syncs.append(1))
    reg = monitor.MetricsRegistry()
    monitor.enable(registry=reg)
    try:
        pi = ParallelInference(pn, pmesh(), queue_limit_ms=20.0).start()
        futs = [pi.output_async(xs(2, seed=i)) for i in range(4)]
        for f in futs:
            f.result(timeout=10)
        pi.stop()
    finally:
        monitor.disable()
        monitor._STATE.registry = monitor.GLOBAL_REGISTRY
    text = reg.exposition()
    for name in ("inference_request_latency_seconds",
                 "inference_queue_depth", "inference_batch_size"):
        assert name in text
    assert syncs == []
    pi2 = ParallelInference(pn, pmesh())
    assert pi2._metrics() is None               # monitoring off


def test_replicas_follow_the_params(nets):
    """A params write (new `params_version`) reaches the replicas'
    forwards; on a repeated device the replica is the model."""
    _, pn = nets
    pi = ParallelInference(pn, pmesh())
    assert all(r is pn for r in pi._replicas())
    before = pi.output(xs(4))
    net2 = pn.copy()
    with torch.no_grad():
        for p in net2.parameters():
            p.mul_(0.5)
    net2.params_changed()
    pi2 = ParallelInference(net2, pmesh())
    np.testing.assert_allclose(pi2.output(xs(4)), net2.output(xs(4)).numpy(),
                               atol=ATOL)
    assert not np.allclose(before, pi2.output(xs(4)))
