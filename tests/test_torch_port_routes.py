"""The port's streaming routes and `csv_to_dataset` against the JAX
package's (`deeplearning4j_tpu/streaming/routes.py`, `records.py`):
the same arrays through a JAX ServingRoute and a port ServingRoute over
twin nets (the LM of the fleet tests, head x8, and a Dense -> Output
MLP, params carried by `util/jax_params.py`) publish outputs within
1e-5; a `model_uri` route restores its zip on the first message only;
`RecordPublishRoute` and `csv_to_dataset` give JAX's arrays."""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.streaming import (
    LocalQueueTransport as JaxTransport,
    NDArrayConsumer as JaxConsumer,
    NDArrayPublisher as JaxPublisher,
    RecordPublishRoute as JaxRecordRoute,
    ServingRoute as JaxRoute,
    csv_to_dataset as jax_csv_to_dataset,
)
from deeplearning4j_tpu_torch.serving import FleetRouter, ShedError
from deeplearning4j_tpu_torch.streaming import (
    LocalQueueTransport,
    NDArrayConsumer,
    NDArrayPublisher,
    RecordPublishRoute,
    ServingRoute,
    csv_to_dataset,
)
from deeplearning4j_tpu_torch.util.jax_params import (
    from_jax_params,
    to_numpy_params,
)
from deeplearning4j_tpu_torch.util.serializer import ModelSerializer
from torch_port_fleet import jax_mlp, port_mlp, twin_lm

OUTPUT_ATOL = 1e-5
V, D, HEADS, LAYERS, MAXLEN = 23, 16, 4, 2, 16


@pytest.fixture(scope="module")
def lm_twin():
    return twin_lm(3, vocab=V, d_model=D, n_layers=LAYERS, n_heads=HEADS,
                   max_len=MAXLEN)


@pytest.fixture(scope="module")
def mlp_twin():
    jnet = jax_mlp(seed=21)
    return jnet, from_jax_params(port_mlp(seed=21),
                                 to_numpy_params(jnet.params))


def _serve_both(jnet, net, inputs, **kw):
    """Publish `inputs` into a JAX route and a port route (each over its
    package's in-process transport), run both, return their outputs."""
    outs = []
    for tr_cls, route_cls, pub_cls, con_cls, model, extra in (
            (JaxTransport, JaxRoute, JaxPublisher, JaxConsumer, jnet, {}),
            (LocalQueueTransport, ServingRoute, NDArrayPublisher,
             NDArrayConsumer, net, dict(device="cpu"))):
        tr = tr_cls()
        pub = pub_cls(tr, "in")
        for x in inputs:
            pub.publish(x)
        route = route_cls(tr, "in", "out", model=model, **kw, **extra)
        assert route.run(timeout=0.5) == len(inputs)
        con = con_cls(tr, "out")
        outs.append([np.asarray(con.consume(timeout=5)) for _ in inputs])
    return outs


def test_lm_route_matches_jax(lm_twin):
    jnet, net = lm_twin
    rng = np.random.default_rng(0)
    inputs = [rng.integers(0, V, (4, MAXLEN)) for _ in range(3)]
    want, got = _serve_both(jnet, net, inputs)
    for w, g in zip(want, got):
        assert g.shape == (4, MAXLEN, V)
        np.testing.assert_allclose(g, w, atol=OUTPUT_ATOL, rtol=0)


def test_mlp_route_with_hooks_matches_jax(mlp_twin):
    jnet, net = mlp_twin
    rng = np.random.default_rng(1)
    inputs = [rng.standard_normal((5, 4)).astype(np.float32)
              for _ in range(4)]
    kw = dict(before=lambda x: x * 2.0,
              final=lambda y: np.argmax(np.asarray(y), -1))
    want, got = _serve_both(jnet, net, inputs, **kw)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    want, got = _serve_both(jnet, net, inputs)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, atol=OUTPUT_ATOL, rtol=0)


def test_model_uri_restores_lazily(tmp_path, mlp_twin):
    _, net = mlp_twin
    zp = tmp_path / "mlp.zip"
    ModelSerializer.write_model(net, zp)
    tr = LocalQueueTransport()
    route = ServingRoute(tr, "in", "out", model_uri=str(zp), device="cpu",
                         model_name="mlp")
    assert route._model is None and not route._attached
    assert route.run(timeout=0.05) == 0         # nothing consumed yet
    assert route._model is None
    x = np.random.default_rng(2).standard_normal((3, 4)).astype(np.float32)
    NDArrayPublisher(tr, "in").publish(x)
    assert route.process_one(timeout=5)
    assert route._model is not None and route._attached
    assert route.model.device == torch.device("cpu")
    out = NDArrayConsumer(tr, "out").consume(timeout=5)
    np.testing.assert_allclose(out, net.output(x).numpy(),
                               atol=OUTPUT_ATOL, rtol=0)


def test_route_shares_the_router_backstop(mlp_twin):
    """A shared router with max_queue 0 sheds the route's forward: the
    error propagates out of process_one, and a background route keeps
    polling through it."""
    _, net = mlp_twin
    tr = LocalQueueTransport()
    router = FleetRouter(max_queue=0)
    route = ServingRoute(tr, "in", "out", model=net, router=router,
                         model_name="mlp", device="cpu")
    NDArrayPublisher(tr, "in").publish(np.zeros((1, 4), np.float32))
    with pytest.raises(ShedError, match="max_queue"):
        route.process_one(timeout=5)
    router.max_queue = None
    route.start(poll_timeout=0.02)
    try:
        x = np.ones((2, 4), np.float32)
        NDArrayPublisher(tr, "in").publish(x)
        out = NDArrayConsumer(tr, "out").consume(timeout=10)
    finally:
        route.stop()
    np.testing.assert_allclose(out, net.output(x).numpy(),
                               atol=OUTPUT_ATOL, rtol=0)


def test_route_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingRoute(LocalQueueTransport(), "in", "out",
                     model_uri=str(tmp_path / "x.zip"))
    with pytest.raises(ValueError, match="model or model_uri"):
        ServingRoute(LocalQueueTransport(), "in", "out", device="cpu")


def test_record_publish_route_matches_jax():
    recs = [[1.0, 2.0, 3.0], [4.5, -1.0, 0.25], [0.0, 0.0, 9.0]]
    got = {}
    for tag, tr_cls, route_cls, con_cls in (
            ("jax", JaxTransport, JaxRecordRoute, JaxConsumer),
            ("port", LocalQueueTransport, RecordPublishRoute,
             NDArrayConsumer)):
        tr = tr_cls()
        plain = route_cls(tr, "a")
        scaled = route_cls(tr, "b",
                           extractor=lambda r: np.asarray(r[:2]) * 3)
        assert plain.publish(recs) == 3 and scaled.publish(recs) == 3
        got[tag] = [np.asarray(con_cls(tr, t).consume(timeout=5))
                    for t in ("a", "b") for _ in recs]
    for w, g in zip(got["jax"], got["port"]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kw", [dict(), dict(num_classes=3),
                                dict(label_index=0, num_classes=4),
                                dict(delimiter=";")])
def test_csv_to_dataset_matches_jax(kw):
    d = kw.get("delimiter", ",")
    lines = [d.join(["0.5", "1", "2.25", "2"]), "",
             d.join(["1.5", "3", "-2", "0"]), "  ",
             d.join(["2", "0", "7", "1"])]
    want = jax_csv_to_dataset(lines, **kw)
    got = csv_to_dataset(lines, **kw)
    for a, b in ((got.features, want.features), (got.labels, want.labels)):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
