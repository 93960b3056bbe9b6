"""The port's ComputationGraph against the JAX package's, on the CPU.

- Every vertex: forward, output type and `to_dict()` equal to JAX's,
  built back from JAX's dict; a JAX `ComputationGraphConfiguration`
  round-trips through the port's `from_dict`, and the port's
  `graph_builder` builds the JAX builder's configuration (global
  defaults included).
- ResNet-50: `conf()` equals JAX's as a dict (32x32, 64x64, 224x224).
  JAX's `init()` params and running state go into the port through
  `from_jax_params` / `from_jax_state`; inference `output()` agrees
  within 1e-4, `num_params` and `param_table` are JAX's. Two `fit`
  steps at batch 2 are held to JAX's: the training of a BatchNorm net
  at batch 2 is ill-conditioned, so each quantity (the loss of each
  step, the params, the running statistics and Nesterov's v after the
  steps, whole tree) must lie within NOISE_FACTOR times JAX's own
  distance to its twin run on images with 1e-7 relative noise (plus
  FLOOR). At 32x32 the last stage's BatchNorm sees 2 values a channel
  and JAX against its twin moves the train-mode output by 0.27 and the
  gradient by 640% (measured with this repo's JAX package, CPU): the
  steps run at 64x64, where the output moves by 5e-5 and the gradient
  by 2.8%.
- A graph of Dense layers trained under Adam with a packed run against
  JAX's graph `fit` (loss, params, m and v), fp32 and `mixed_bf16`; the
  port packs (and takes fused Adam for) exactly JAX's runs.
- Graph zips: the port's restores in the JAX package; the JAX-written
  fixture (tests/fixtures/bridge/resnet_small.zip, by
  tests/fixtures/make_graph_fixtures.py) regenerates equal to the
  committed one. Phase 10 of `chip_smoke.py` in its small mode is
  rehearsed in `tests/test_torch_port_phase10.py`.
- `evaluate`, `evaluate_roc_multi_class` equal JAX's; the unported
  graph features are refused by name.
"""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import importlib.util
import io
import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.common.updaters import Adam as JaxAdam
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.nn.conf import graph as jgraph
from deeplearning4j_tpu.nn.conf.builder import (
    NeuralNetConfiguration as JaxBuilder,
)
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf.preprocessors import (
    CnnToFeedForwardPreProcessor as JaxCnnToFF,
)
from deeplearning4j_tpu.nn.graph import (
    ComputationGraph as JaxGraph,
    ComputationGraphConfiguration as JaxGraphConf,
)
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.optimize.listeners import TrainingListener as JaxLis
from deeplearning4j_tpu.util.serializer import ModelSerializer as JaxZip
from deeplearning4j_tpu.zoo.resnet50 import ResNet50 as JaxResNet50
from deeplearning4j_tpu_torch.common.updaters import Adam
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn import container as pcontainer
from deeplearning4j_tpu_torch.nn.conf import graph as pgraph
from deeplearning4j_tpu_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph,
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener
from deeplearning4j_tpu_torch.util.jax_params import (
    from_jax_params,
    from_jax_state,
    from_jax_updater_state,
    to_jax_params,
    to_jax_state,
    to_jax_updater_state,
)
from deeplearning4j_tpu_torch.util.serializer import ModelSerializer
from deeplearning4j_tpu_torch.zoo import ResNet50

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
_spec = importlib.util.spec_from_file_location(
    "make_graph_fixtures", os.path.join(FIXTURES, "make_graph_fixtures.py"))
fixtures = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fixtures)

ATOL = 1e-5
OUTPUT_ATOL = 1e-4
NOISE, NOISE_FACTOR, FLOOR = 1e-7, 3.0, 1e-5
LOSS_RTOL, PARAM_RTOL = 1e-5, 1e-4
STEP0_RTOL, BAND = 1e-2, 0.05
# regenerated fixtures on another CPU: equal up to XLA:CPU's rounding
ARRAY_RTOL, GOLDEN_TOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _no_env_policy(monkeypatch):
    monkeypatch.delenv("DL4J_DTYPE_POLICY", raising=False)


def _np(tree):
    """A numpy copy of a JAX {key: {name: array}} tree (the JAX step
    donates its buffers)."""
    return {str(k): {n: np.array(a) for n, a in lv.items()}
            for k, lv in tree.items()}


def _dist(got, want):
    """Whole-tree relative Frobenius distance of {key: {name: array}}."""
    num = sum(float(np.sum((np.asarray(got[k][n], np.float64)
                            - np.asarray(w, np.float64)) ** 2))
              for k, lv in want.items() for n, w in lv.items())
    den = sum(float(np.sum(np.asarray(w, np.float64) ** 2))
              for lv in want.values() for w in lv.values())
    return np.sqrt(num / max(den, 1e-30))


# ----------------------------------------------------------------- vertices
def _vertex_cases():
    rng = np.random.default_rng(0)
    ff = lambda *s: rng.standard_normal(s).astype(np.float32)   # noqa: E731
    T = JaxInputType
    mask = np.array([[1, 1, 1, 0], [1, 1, 0, 0], [1, 0, 0, 0]], np.float32)
    return [
        (jgraph.ElementWiseVertex("add"), [ff(3, 5), ff(3, 5), ff(3, 5)],
         [T.feed_forward(5)] * 3, None),
        (jgraph.ElementWiseVertex("subtract"), [ff(3, 5), ff(3, 5)],
         [T.feed_forward(5)] * 2, None),
        (jgraph.ElementWiseVertex("product"), [ff(3, 4, 2, 6), ff(3, 4, 2, 6)],
         [T.convolutional(4, 2, 6)] * 2, None),
        (jgraph.ElementWiseVertex("average"), [ff(3, 5), ff(3, 5)],
         [T.feed_forward(5)] * 2, None),
        (jgraph.ElementWiseVertex("max"), [ff(3, 5), ff(3, 5)],
         [T.feed_forward(5)] * 2, None),
        (jgraph.MergeVertex(), [ff(3, 4, 2, 6), ff(3, 4, 2, 2)],
         [T.convolutional(4, 2, 6), T.convolutional(4, 2, 2)], None),
        (jgraph.MergeVertex(), [ff(3, 4, 5), ff(3, 4, 2)],
         [T.recurrent(5, 4), T.recurrent(2, 4)], None),
        (jgraph.SubsetVertex(1, 3), [ff(3, 6)], [T.feed_forward(6)], None),
        (jgraph.SubsetVertex(0, 2), [ff(3, 4, 6)], [T.recurrent(6, 4)],
         None),
        (jgraph.L2Vertex(), [ff(3, 5), ff(3, 5)], [T.feed_forward(5)] * 2,
         None),
        (jgraph.L2NormalizeVertex(), [ff(3, 4, 2, 6)],
         [T.convolutional(4, 2, 6)], None),
        (jgraph.ScaleVertex(2.5), [ff(3, 5)], [T.feed_forward(5)], None),
        (jgraph.ShiftVertex(-1.5), [ff(3, 5)], [T.feed_forward(5)], None),
        (jgraph.ReshapeVertex((2, 6)), [ff(3, 12)], [T.feed_forward(12)],
         None),
        (jgraph.ReshapeVertex((2, 3, 2)), [ff(3, 12)], [T.feed_forward(12)],
         None),
        (jgraph.StackVertex(), [ff(3, 5), ff(2, 5)],
         [T.feed_forward(5)] * 2, None),
        (jgraph.UnstackVertex(1, 3), [ff(6, 5)], [T.feed_forward(5)], None),
        (jgraph.LastTimeStepVertex(), [ff(3, 4, 5)], [T.recurrent(5, 4)],
         None),
        (jgraph.LastTimeStepVertex(), [ff(3, 4, 5)], [T.recurrent(5, 4)],
         [mask]),
        (jgraph.DuplicateToTimeSeriesVertex(), [ff(3, 5), ff(3, 4, 2)],
         [T.feed_forward(5), T.recurrent(2, 4)], None),
        (jgraph.PoolHelperVertex(), [ff(3, 4, 5, 2)],
         [T.convolutional(4, 5, 2)], None),
    ]


@pytest.mark.parametrize("case", range(len(_vertex_cases())))
def test_vertex_matches_jax(case):
    jv, xs, types, masks = _vertex_cases()[case]
    pv = pgraph.vertex_from_dict(jv.to_dict())
    assert pv.to_dict() == jv.to_dict()
    assert pgraph.vertex_from_dict(pv.to_dict()) == pv
    want = jv.forward([jnp.asarray(x) for x in xs],
                      masks=None if masks is None else
                      [jnp.asarray(m) for m in masks])
    got = pv.forward([torch.from_numpy(x) for x in xs],
                     masks=None if masks is None else
                     [torch.from_numpy(m) for m in masks])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ATOL,
                               atol=ATOL)
    ptypes = [InputType.from_dict(t.to_dict()) for t in types]
    assert pv.get_output_type(ptypes).to_dict() == \
        jv.get_output_type(types).to_dict()
    jm = jv.forward_mask(masks)
    pm = pv.forward_mask(masks)
    assert (jm is None) == (pm is None)


def test_preprocessor_vertex_round_trips_and_refuses_its_forward():
    """The vertex round-trips and types as JAX's; its forward, refused
    until the preprocessors were ported, now equals JAX's bit for bit
    (the graph case: tests/test_torch_port_preprocessors.py)."""
    jv = jgraph.PreprocessorVertex(JaxCnnToFF(4, 2, 3))
    pv = pgraph.vertex_from_dict(jv.to_dict())
    assert pv.to_dict() == jv.to_dict()
    it = JaxInputType.convolutional(4, 2, 3)
    assert pv.get_output_type([InputType.from_dict(it.to_dict())]).to_dict() \
        == jv.get_output_type([it]).to_dict()
    x = np.random.default_rng(2).standard_normal((2, 4, 2, 3)).astype(
        np.float32)
    assert np.array_equal(pv.forward([torch.from_numpy(x)]).numpy(),
                          np.asarray(jv.forward([jnp.asarray(x)])))


# ----------------------------------------------------------- configuration
def _dag(builder, g, layers):
    """in -> d0 -> d1 -> d2 -> d3; merge(d3, d0) -> out: d0 feeds two
    nodes, so the chain of identical layers is d1..d3."""
    b = g(builder)
    b.add_inputs("in")
    b.set_input_types(layers["it"](6))
    b.add_layer("d0", layers["dense"](n_out=8, activation="tanh"), "in")
    for i in (1, 2, 3):
        b.add_layer(f"d{i}", layers["dense"](n_out=8, activation="tanh"),
                    f"d{i - 1}")
    b.add_vertex("m", layers["merge"](), "d3", "d0")
    b.add_layer("out", layers["out"](n_out=3), "m")
    b.set_outputs("out")
    return b.build()


JAX_LAYERS = dict(it=JaxInputType.feed_forward, dense=jff.DenseLayer,
                  merge=jgraph.MergeVertex, out=jff.OutputLayer)
PORT_LAYERS = dict(it=InputType.feed_forward, dense=DenseLayer,
                   merge=pgraph.MergeVertex, out=OutputLayer)


def _jax_dag(gn=None, policy=None):
    b = JaxBuilder.builder().seed(5).updater(JaxAdam(1e-2)).l2(1e-3)
    if gn is not None:
        b = b.gradient_normalization(gn, 1.0)
    if policy is not None:
        b = b.dtype_policy(policy)
    return _dag(b, JaxGraphConf.graph_builder, JAX_LAYERS)


def test_graph_builder_builds_the_jax_configuration():
    jconf = _jax_dag()
    pconf = _dag(NeuralNetConfiguration.builder().seed(5).updater(
        Adam(1e-2)).l2(1e-3), lambda b: b.graph_builder(), PORT_LAYERS)
    assert pconf.to_dict() == jconf.to_dict()
    assert ComputationGraphConfiguration.from_json(
        jconf.to_json()).to_dict() == jconf.to_dict()
    assert pconf.topo_order == jconf.topo_order


@pytest.mark.parametrize("hw", [32, 64, 224])
def test_resnet50_conf_equals_jax(hw):
    kw = dict(num_classes=10, height=hw, width=hw) if hw != 224 else {}
    jconf = JaxResNet50(**kw).conf()
    assert ResNet50(**kw).conf().to_dict() == jconf.to_dict()
    back = ComputationGraphConfiguration.from_dict(jconf.to_dict())
    assert back.to_dict() == jconf.to_dict()


def test_zoo_refuses_pretrained_weights():
    with pytest.raises(NotImplementedError, match="no weights"):
        ResNet50().init_pretrained()


# ---------------------------------------------------------------- ResNet-50
class _Losses(JaxLis, TrainingListener):
    def __init__(self):
        self.losses = []

    def iteration_done(self, model, iteration, epoch, score, **info):
        self.losses.append(float(score))


@pytest.fixture(scope="module")
def resnet():
    """JAX's ResNet-50 (10 classes, 64x64) from `init()`, with the JAX
    benchmark's Nesterovs(0.005, 0.9) (at the zoo's 0.1 the loss goes
    from 6.8 to 257 in one step at this batch); two `fit` steps at batch
    2 on clean and on noisy images from the same start, and the port
    loaded with the same init and trained on the clean images."""
    from deeplearning4j_tpu.common.updaters import Nesterovs as JaxNesterovs
    conf = JaxResNet50(num_classes=10, height=64, width=64).conf()
    for node in conf.nodes.values():      # the JAX benchmark's rate
        if node.layer is not None:        # (bench.py:250-259)
            node.layer.updater = JaxNesterovs(0.005, 0.9)
    jnet = JaxGraph(conf).init()
    start = (_np(jnet.params), _np(jnet.net_state),
             {k: {n: {s: np.asarray(a) for s, a in st.items()}
                  for n, st in lv.items()}
              for k, lv in jnet.updater_state.items()})
    net = ComputationGraph(ComputationGraphConfiguration.from_json(
        conf.to_json()), device="cpu")
    from_jax_params(net, start[0])
    from_jax_state(net, start[1])
    from_jax_updater_state(net, start[2], 0)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 2)]
    # the batch twice: two steps that descend (on fresh random batches
    # the second step's loss is 2.5x the first's, in JAX too)
    x, y = np.concatenate([x, x]), np.concatenate([y, y])
    probe = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    out = (net.output(probe).numpy(), np.asarray(jnet.output(probe)))
    runs = {}
    for tag, xx in (("clean", x), ("noisy", x * (1 + NOISE * rng.standard_normal(
            x.shape).astype(np.float32)))):
        jnet.params = jax.tree_util.tree_map(jnp.asarray, start[0])
        jnet.net_state = jax.tree_util.tree_map(jnp.asarray, start[1])
        jnet.updater_state = jax.tree_util.tree_map(jnp.asarray, start[2])
        jnet.iteration_count = 0
        lis = _Losses()
        jnet.set_listeners(lis)
        jnet.fit(xx, y, batch_size=2)
        runs[tag] = dict(loss={"": {str(i): np.float32(v) for i, v in
                                    enumerate(lis.losses)}},
                         params=_np(jnet.params), state=_np(jnet.net_state),
                         v={k: {n: np.asarray(st["v"]) for n, st in lv.items()}
                            for k, lv in jnet.updater_state.items()})
    lis = _Losses()
    net.set_listeners(lis)
    net.fit(x, y, batch_size=2)
    runs["port"] = dict(loss={"": {str(i): np.float32(v) for i, v in
                                   enumerate(lis.losses)}},
                        params=to_jax_params(net), state=to_jax_state(net),
                        v={k: {n: st["v"] for n, st in lv.items()}
                           for k, lv in to_jax_updater_state(net).items()})
    return dict(jnet=jnet, net=net, out=out, runs=runs, start=start)


def test_resnet50_output_and_param_table_match_jax(resnet):
    got, want = resnet["out"]
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got, want, atol=OUTPUT_ATOL)
    net, start = resnet["net"], resnet["start"]
    assert net.num_params() == sum(a.size for lv in start[0].values()
                                   for a in lv.values())
    table = net.param_table()
    assert set(table) == {f"{k}_{n}" for k, lv in start[0].items()
                          for n in lv}
    assert tuple(table["stem_conv_W"].shape) == (7, 7, 3, 64)      # HWIO
    assert set(net.net_state) == set(start[1])


@pytest.mark.parametrize("what", ["loss", "params", "state", "v"])
def test_resnet50_fit_matches_jax_within_its_own_noise(what, resnet):
    r = resnet["runs"]
    to_jax = _dist(r["port"][what], r["clean"][what])
    to_twin = _dist(r["noisy"][what], r["clean"][what])
    assert to_jax <= NOISE_FACTOR * to_twin + FLOOR, (what, to_jax, to_twin)


def test_resnet50_fit_step_0_loss_matches_jax(resnet):
    r = resnet["runs"]
    np.testing.assert_allclose(r["port"]["loss"][""]["0"],
                               r["clean"]["loss"][""]["0"], rtol=1e-4)


# ----------------------------------------------- Adam over a packed graph run
def _dag_data(seed, n=12):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 6)).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]


@pytest.mark.parametrize("gn,runs", [(None, [["d1", "d2", "d3"]]),
                                     ("clip_l2_per_layer", [])])
@pytest.mark.parametrize("policy", [None, "mixed_bf16"])
def test_graph_adam_with_a_packed_run_matches_jax(gn, runs, policy,
                                                  monkeypatch):
    jnet = JaxGraph(_jax_dag(gn, policy)).init(2)
    net = ComputationGraph(ComputationGraphConfiguration.from_json(
        jnet.conf.to_json()), device="cpu")
    from_jax_params(net, _np(jnet.params))
    assert [[net.layer_keys[i] for i in r] for r in net._packed_runs()] \
        == jnet._packed_runs(jnet.params) == runs
    calls = []
    orig = pcontainer.adam_update_packed

    def spy(updater, ps, *a):
        calls.append(len(ps))
        return orig(updater, ps, *a)
    monkeypatch.setattr(pcontainer, "adam_update_packed", spy)
    x, y = _dag_data(1)
    jl, pl = _Losses(), _Losses()
    jnet.set_listeners(jl)
    net.set_listeners(pl)
    jnet.fit(x, y, batch_size=4)
    net.fit(x, y, batch_size=4)
    assert calls == [2 * len(r) for r in runs] * 3
    if policy is None:
        np.testing.assert_allclose(pl.losses, jl.losses, rtol=LOSS_RTOL)
        assert _dist(to_jax_params(net), _np(jnet.params)) <= PARAM_RTOL
        for slot in ("m", "v"):
            want = {k: {n: np.asarray(st[slot]) for n, st in lv.items()}
                    for k, lv in jnet.updater_state.items()}
            got = {k: {n: st[slot] for n, st in lv.items()}
                   for k, lv in to_jax_updater_state(net).items()}
            assert _dist(got, want) <= PARAM_RTOL, slot
    else:
        assert abs(pl.losses[0] - jl.losses[0]) <= STEP0_RTOL * jl.losses[0]
        assert abs(pl.losses[-1] - jl.losses[-1]) <= BAND * jl.losses[0]
        assert all(p.dtype == torch.float32 for p in net.parameters())


# --------------------------------------------------------------- the zips
def test_port_graph_zip_restores_in_jax(tmp_path):
    """A port graph with running state, trained 2 steps, written: the
    JAX package restores the same params, running state, Nesterov state
    and counters, and the same `output()`; the port restores it back."""
    from deeplearning4j_tpu.common.updaters import Nesterovs as JaxNesterovs
    conf = fixtures.conf(JaxResNet50, JaxNesterovs(fixtures.LR, 0.9))
    net = ComputationGraph(ComputationGraphConfiguration.from_json(
        conf.to_json()), device="cpu").init(3)
    x, y = fixtures.images(5, 2 * fixtures.B)
    net.fit(DataSet(x, y), batch_size=fixtures.B)
    path = tmp_path / "graph.zip"
    ModelSerializer.write_model(net, path)
    back = JaxZip.restore_model(path)
    assert type(back).__name__ == "ComputationGraph"
    assert back.iteration_count == net.iteration_count == 2
    for got, want in ((back.params, to_jax_params(net)),
                      (back.net_state, to_jax_state(net))):
        for k, lv in want.items():
            for n, a in lv.items():
                np.testing.assert_array_equal(np.asarray(got[k][n]), a)
    np.testing.assert_allclose(np.asarray(back.output(x)),
                               net.output(x).numpy(), atol=ATOL)
    again = ModelSerializer.restore_model(path, device="cpu")
    assert isinstance(again, ComputationGraph)
    assert torch.equal(again.output(x), net.output(x))


def _zip_arrays(path):
    with zipfile.ZipFile(path) as zf:
        return (json.loads(zf.read("configuration.json")),
                json.loads(zf.read("meta.json")),
                {n: dict(np.load(io.BytesIO(zf.read(n))))
                 for n in zf.namelist() if n.endswith(".npz")})


def test_regenerated_graph_fixture_matches_the_committed_one(tmp_path):
    fixtures.make(str(tmp_path))
    here = os.path.join(FIXTURES, "bridge")
    conf, meta, arrays = _zip_arrays(os.path.join(here, "resnet_small.zip"))
    conf2, meta2, arrays2 = _zip_arrays(tmp_path / "resnet_small.zip")
    assert conf == conf2
    assert {k: v for k, v in meta.items() if k != "array_checksums"} == \
        {k: v for k, v in meta2.items() if k != "array_checksums"}
    assert set(arrays) == set(arrays2) == {"params.npz", "state.npz",
                                           "updater.npz"}
    for member, arrs in arrays.items():
        assert arrs.keys() == arrays2[member].keys()
        for k, a in arrs.items():
            b = arrays2[member][k]
            assert a.shape == b.shape and a.dtype == b.dtype, k
            assert np.linalg.norm(b - a) <= ARRAY_RTOL * max(
                np.linalg.norm(a), 1e-6), k
    g, g2 = (np.load(p) for p in (os.path.join(here,
                                               "resnet_small_golden.npz"),
                                  tmp_path / "resnet_small_golden.npz"))
    assert set(g.files) == set(g2.files)
    for k in g.files:
        if k.startswith("sum/"):
            scale = abs(float(g[k])) + np.sqrt(float(g["sumsq" + k[3:]]))
            assert abs(float(g2[k]) - float(g[k])) <= ARRAY_RTOL * max(
                scale, 1.0), k
        elif k.startswith("sumsq/"):
            assert abs(float(g2[k]) - float(g[k])) <= ARRAY_RTOL * max(
                float(g[k]), 1.0), k
        else:
            np.testing.assert_allclose(g2[k], g[k], rtol=GOLDEN_TOL,
                                       atol=GOLDEN_TOL, err_msg=k)
    assert os.path.getsize(os.path.join(here, "resnet_small.zip")) < 2 ** 20


# ------------------------------------------------------- evaluation, refusals
def test_graph_evaluate_matches_jax():
    jnet = JaxGraph(_jax_dag()).init(7)
    net = from_jax_params(ComputationGraph(
        ComputationGraphConfiguration.from_json(jnet.conf.to_json()),
        device="cpu"), _np(jnet.params))
    x, y = _dag_data(8, 40)
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(jnet.output(x)), atol=ATOL)
    e, je = net.evaluate(DataSet(x, y)), jnet.evaluate(JaxDataSet(x, y))
    assert np.array_equal(e.confusion.matrix, je.confusion.matrix)
    r = net.evaluate_roc_multi_class(DataSet(x, y))
    jr = jnet.evaluate_roc_multi_class(JaxDataSet(x, y))
    for c in range(3):
        np.testing.assert_allclose(r.calculate_auc(c), jr.calculate_auc(c),
                                   atol=1e-6)
    acts = net.feed_forward(x)
    assert set(acts) == set(jnet.feed_forward(x))
    np.testing.assert_allclose(net.score(DataSet(x, y)),
                               jnet.score(JaxDataSet(x, y)), rtol=1e-5)


@pytest.mark.parametrize("what", ["tbptt", "gradient_sharing",
                                  "steps_per_execution", "rnn_time_step",
                                  "pretrain"])
def test_unported_graph_features_are_refused_by_name(what):
    """TBPTT, `steps_per_execution`, `rnn_time_step`, `pretrain` and a
    configured `gradient_sharing` are ported: on this feed-forward DAG
    they do what JAX's graph does (a plain step on [B, F] features, two
    steps in one group, a one-step stream, no layer to pretrain so the
    params stay JAX's, and a "threshold" graph's own `fit` trains as a
    dense one, since only the parallel trainers read the field), from
    `init()`'s JAX weights; the rest is refused by name."""
    conf = _jax_dag()
    if what == "tbptt":
        conf.backprop_type = type(conf.backprop_type)("tbptt")
    if what == "gradient_sharing":
        conf.gradient_sharing = "threshold"
    net = ComputationGraph(ComputationGraphConfiguration.from_json(
        conf.to_json()), device="cpu").init()
    x, y = _dag_data(9, 4)
    jnet = JaxGraph(conf).init()
    if what in ("tbptt", "gradient_sharing"):
        jnet.fit(x, y, batch_size=4)
        net.fit(x, y, batch_size=4)
        got, want = net.output(x).numpy(), np.asarray(jnet.output(x))
    elif what == "steps_per_execution":
        jnet.fit(x, y, batch_size=2, steps_per_execution=2)
        net.fit(x, y, batch_size=2, steps_per_execution=2)
        assert net.iteration_count == jnet.iteration_count == 2
        got, want = net.output(x).numpy(), np.asarray(jnet.output(x))
    elif what == "pretrain":
        jnet.pretrain(x, batch_size=4)
        net.pretrain(x, batch_size=4)
        got, want = net.output(x).numpy(), np.asarray(jnet.output(x))
    else:
        got = net.rnn_time_step(x).numpy()
        want = np.asarray(jnet.rnn_time_step(x))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
