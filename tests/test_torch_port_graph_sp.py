"""Sequence parallelism inside a `ComputationGraph` (the port used to
refuse it at construction; JAX's graph runs it through the layer's
ambient context, `nn/graph.py:353-385`): a graph transformer with
`sequence_parallel="ring"` and one with "ulysses" under a seq=4 mesh,
their output and one `fit` step held to JAX's graph on the same params
and mesh shape, with the tolerances of the port's multi-layer SP tests
(`test_torch_port_ring.py`); and entering or leaving the context
between calls changes the schedule, not the answer."""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import numpy as np
import pytest

from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JBuilder
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.graph import (
    ComputationGraphConfiguration as JGraphConf,
)
from deeplearning4j_tpu.parallel import MeshSpec as JMeshSpec
from deeplearning4j_tpu.parallel import make_mesh as jmake_mesh
from deeplearning4j_tpu.parallel import sequence_sharding as jsharding
from deeplearning4j_tpu.zoo.transformer import TransformerLM as JLM
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph,
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.parallel import (
    MeshSpec,
    make_mesh,
    sequence_sharding,
)
from deeplearning4j_tpu_torch.util.jax_params import from_jax_params

OUT_RTOL, OUT_ATOL = 2e-4, 2e-5      # test_torch_port_ring.py's
LOSS_RTOL, PARAM_RTOL = 1e-5, 1e-4
V, T = 16, 16


def graph_lm(sp):
    conf = JLM(vocab_size=V, d_model=32, n_layers=2, n_heads=4, max_len=T,
               sequence_parallel=sp, seed=7).conf()
    g = JGraphConf.graph_builder(JBuilder.builder().seed(conf.seed))
    g.add_inputs("ids")
    prev = "ids"
    for i, layer in enumerate(conf.layers):
        g.add_layer(str(i), layer, prev)
        prev = str(i)
    g.set_outputs(prev)
    jconf = g.build()
    jnet = JGraph(jconf).init()
    net = ComputationGraph(ComputationGraphConfiguration.from_json(
        jconf.to_json()), device="cpu")
    net = from_jax_params(net, {k: {n: np.asarray(v) for n, v in lp.items()}
                                for k, lp in jnet.params.items()})
    return jnet, net


def corpus(seed=0):
    seq = np.random.default_rng(seed).integers(0, V, (2, T + 1))
    return (seq[:, :-1].astype(np.float32),
            np.eye(V, dtype=np.float32)[seq[:, 1:]])


def _one(o):
    return o[0] if isinstance(o, (list, tuple)) else o


@pytest.mark.parametrize("sp", ["ring", "ulysses"])
def test_graph_sequence_parallel_matches_jax(sp):
    jnet, net = graph_lm(sp)
    x, y = corpus()
    with jsharding(jmake_mesh(JMeshSpec.of(seq=4)), axis="seq"):
        jout = np.asarray(_one(jnet.output(x)))
        jnet.fit(x, y, epochs=1, batch_size=2)
    mesh = make_mesh(MeshSpec.of(seq=4), devices=["cpu"] * 4)
    with sequence_sharding(mesh, axis="seq"):
        out = _one(net.output(x)).numpy()
        net.fit(x, y, epochs=1, batch_size=2)
    np.testing.assert_allclose(out, jout, rtol=OUT_RTOL, atol=OUT_ATOL)
    np.testing.assert_allclose(net.score_value, float(jnet.score_value),
                               rtol=LOSS_RTOL)
    got = net.param_table()
    for lk, lp in jnet.params.items():
        for pn, w in lp.items():
            w = np.asarray(w)
            diff = got[f"{lk}_{pn}"].numpy() - w
            if pn == "attn_bk":          # its true gradient is zero
                continue
            rel = np.linalg.norm(diff) / max(np.linalg.norm(w), 1e-12)
            assert rel <= PARAM_RTOL, (lk, pn, rel)


@pytest.mark.parametrize("sp", ["ring", "ulysses"])
def test_context_changes_between_calls(sp):
    """Nothing the graph keeps depends on the ambient (mesh, axis): the
    same graph answers outside, inside a 4-way and inside a 2-way
    context, each time as the local path does."""
    _, net = graph_lm(sp)
    x, _ = corpus(1)
    local = _one(net.output(x)).numpy()
    for n in (4, 2):
        mesh = make_mesh(MeshSpec.of(seq=n), devices=["cpu"] * n)
        with sequence_sharding(mesh, axis="seq"):
            inside = _one(net.output(x)).numpy()
        np.testing.assert_allclose(inside, local, rtol=OUT_RTOL, atol=1e-6)
    np.testing.assert_array_equal(_one(net.output(x)).numpy(), local)
