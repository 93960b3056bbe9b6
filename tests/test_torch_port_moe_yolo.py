"""The port's MixtureOfExperts and Yolo2OutputLayer against the JAX
package's, on the CPU: the MoE gates (sort-based top-k, so a tie at the
k-th place selects more than k experts, in both packages), the
load-balance loss, `init(seed)`, and two `fit` steps of both containers
with the load-balance loss in the objective and nowhere else; the Yolo2
forward, `compute_loss` and its gradient, `get_predicted_objects` and
the matrices; and a small YOLO-shaped graph (chip_smoke's `yolo2_conf`
at 1/16 of the widths, with the passthrough and the merge) trained two
steps against JAX.

Tolerances: ATOL = 1e-5 of the largest |value| of JAX's result; bf16
gates within 2 bf16 ulps of the largest gate. The YOLO graph runs 24
convolutions with BatchNorm at batch 4 over maps down to 2x2: after step
0 its trajectory is held to NOISE_FACTOR = 3 x JAX's own distance to a
twin with NOISE = 1e-6 relative noise on its images, plus ATOL. (Its
step-0 update sits 4.5e-5 from JAX's, relative to the update, where a
1e-7-noise twin's sits 1.9e-5; the next loss amplifies either to
1e-4-2e-4 of itself, a 1e-7-noise twin's to 5e-6.)
"""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from deeplearning4j_tpu.common.updaters import Adam as JaxAdam
from deeplearning4j_tpu.common.updaters import Sgd as JaxSgd
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.nn.conf.builder import (
    NeuralNetConfiguration as JaxBuilder,
)
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.graph import (
    ComputationGraphConfiguration as JaxGraphConf,
)
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.layers import moe as jmoe
from deeplearning4j_tpu.nn.layers import objdetect as jyolo
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf.builder import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph,
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers import layer_from_dict
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.jax_params import (
    from_jax_params,
    to_jax_params,
    to_jax_state,
    to_numpy_params,
)

ATOL = 1e-5
NOISE, NOISE_FACTOR = 1e-6, 3.0
F, E, HID = 8, 4, 6


@pytest.fixture(autouse=True)
def _no_env_policy(monkeypatch):
    monkeypatch.delenv("DL4J_DTYPE_POLICY", raising=False)


def _close(got, want, tol=ATOL, what=""):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max abs err {err} (tol {tol})"


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _moe(top_k=2, **kw):
    jl = jmoe.MixtureOfExperts(n_in=F, n_out=F, n_experts=E,
                               hidden_size=HID, top_k=top_k, **kw)
    pl = layer_from_dict(jl.to_dict())
    params = jl.init_params(jax.random.PRNGKey(3))
    pl.load_jax_params({k: np.asarray(v) for k, v in params.items()})
    return jl, pl, params


# ----------------------------------------------------------------- MoE
@pytest.mark.parametrize("top_k", [1, 2, E])
def test_moe_gates_and_load_balance_match_jax(top_k):
    jl, pl, params = _moe(top_k)
    x = _x((3, 5, F), 1)
    gates, aux = jax.jit(jl._gate)(params, jnp.asarray(x))
    g, a = pl.gate(torch.from_numpy(x))
    _close(g.numpy(), np.asarray(gates), what="gates")
    _close(float(a), float(aux), what="aux")
    np.testing.assert_array_equal(g.numpy() > 0, np.asarray(gates) > 0)


def test_moe_gates_match_jax_bf16():
    jl, pl, params = _moe()
    x = _x((4, 16, F), 2)
    pb = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), params)
    gates, _ = jax.jit(jl._gate)(pb, jnp.asarray(x).astype(jnp.bfloat16))
    pl.to(torch.bfloat16)
    g, _ = pl.gate(torch.from_numpy(x).to(torch.bfloat16))
    want = np.asarray(gates.astype(jnp.float32))
    np.testing.assert_array_equal(g.float().numpy() > 0, want > 0)
    assert np.abs(g.float().numpy() - want).max() <= 2 * 2.0 ** -8


def test_moe_tie_at_the_kth_place_selects_three_experts():
    """Two identical router columns tie at the 2nd place: both keep
    their gate, so top-2 selects 3 experts, in both packages."""
    jl, pl, params = _moe(top_k=2)
    wg = np.zeros((F, E), np.float32)
    wg[0] = (3.0, 1.0, 1.0, -2.0)
    params = dict(params, Wg=jnp.asarray(wg))
    pl.load_jax_params({k: np.asarray(v) for k, v in params.items()})
    x = np.zeros((2, F), np.float32)
    x[:, 0] = 1.0
    gates, _ = jl._gate(params, jnp.asarray(x))
    g, _ = pl.gate(torch.from_numpy(x))
    assert ((np.asarray(gates) > 0).sum(-1) == 3).all()
    assert ((g.numpy() > 0).sum(-1) == 3).all()
    _close(g.numpy(), np.asarray(gates), what="tied gates")


def test_moe_forward_and_gradients_match_jax():
    """The forward in training and the gradients of sum(y * r) + the
    load-balance loss in x and every param."""
    jl, pl, params = _moe(load_balance_coef=0.05)
    x = _x((2, 7, F), 4)
    r = _x((2, 7, F), 5)

    def jf(p, xx):
        y, st = jl.forward(p, {}, xx, train=True)
        return jnp.sum(y * r) + st["aux_loss"]
    gp, gx = jax.jit(jax.grad(jf, argnums=(0, 1)))(params, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    pmap = pl.jax_param_map()
    for t in pmap.values():
        t.requires_grad_(True)
    st = {}
    y = pl(xt, train=True, new_state=st)
    ((y * torch.from_numpy(r)).sum() + st["aux_loss"]).backward()
    _close(xt.grad.numpy(), np.asarray(gx), what="grad x")
    for k, t in pmap.items():
        _close(t.grad.numpy(), np.asarray(gp[k]), what=f"grad {k}")


def _moe_mln():
    return (JaxBuilder.builder().seed(5).updater(JaxAdam(1e-2)).list()
            .layer(jmoe.MixtureOfExperts(n_experts=E, hidden_size=HID,
                                         top_k=2, load_balance_coef=0.1))
            .layer(jff.OutputLayer(n_out=3))
            .set_input_type(JaxInputType.feed_forward(F)).build())


def _moe_graph():
    return (JaxGraphConf.graph_builder(JaxBuilder.builder().seed(6)
                                       .updater(JaxSgd(0.5)))
            .add_inputs("x").set_input_types(JaxInputType.feed_forward(F))
            .add_layer("moe", jmoe.MixtureOfExperts(
                n_experts=E, hidden_size=HID, top_k=2,
                load_balance_coef=0.1), "x")
            .add_layer("out", jff.OutputLayer(n_out=3), "moe")
            .set_outputs("out").build())


def _labels(n, k, seed):
    return np.eye(k, dtype=np.float32)[
        np.random.default_rng(seed).integers(0, k, n)]


@pytest.mark.parametrize("container", ["multilayer", "graph"])
def test_moe_fit_matches_jax_and_aux_never_persists(container):
    """`init(seed)` and two `fit` steps in both packages: each step's
    loss (the load-balance loss in it) and the params within ATOL; the
    load-balance loss is never kept in the running state, and `score()`
    and `output()` (no load-balance loss) equal JAX's."""
    if container == "multilayer":
        jconf = _moe_mln()
        jnet = JaxNet(jconf).init(9)
        net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
            jconf.to_json()), device="cpu").init(9)
    else:
        jconf = _moe_graph()
        jnet = JaxGraph(jconf).init(9)
        net = ComputationGraph(ComputationGraphConfiguration.from_json(
            jconf.to_json()), device="cpu").init(9)
    for key, lp in to_numpy_params(jnet.params).items():
        for name, a in lp.items():
            _close(to_jax_params(net)[key][name], a, what=f"init {name}")
    from_jax_params(net, to_numpy_params(jnet.params))
    x, y = _x((8, F), 7), _labels(8, 3, 8)
    for i in (0, 4):
        jnet.fit(JaxDataSet(x[i:i + 4], y[i:i + 4]))
        net.fit(DataSet(x[i:i + 4], y[i:i + 4]))
        _close(net.score_value, float(jnet.score_value), what="loss")
        assert not any(net.net_state.values())
    for key, lp in to_numpy_params(jnet.params).items():
        for name, a in lp.items():
            _close(to_jax_params(net)[key][name], a, what=f"{key} {name}")
    _close(net.score(DataSet(x, y)), float(jnet.score(JaxDataSet(x, y))),
           what="score")
    _close(net.output(x).numpy(), np.asarray(jnet.output(x)), what="output")


# ----------------------------------------------------------------- Yolo2
A, C, G = 2, 3, 4
ANCHORS = ((1.0, 1.5), (2.5, 2.0))


def _yolo():
    jl = jyolo.Yolo2OutputLayer(anchors=ANCHORS, lambda_coord=5.0,
                                lambda_no_obj=0.5)
    return jl, layer_from_dict(jl.to_dict())


def test_yolo2_forward_matches_jax():
    jl, pl = _yolo()
    x = _x((2, G, G, A * (5 + C)), 11)
    y0 = jax.jit(lambda xx: jl.forward({}, {}, xx)[0])(jnp.asarray(x))
    _close(pl(torch.from_numpy(x)).numpy(), np.asarray(y0), what="forward")


def test_yolo2_loss_and_gradient_match_jax():
    jl, pl = _yolo()
    x = _x((3, G, G, A * (5 + C)), 12)
    labels = chip_smoke.yolo_labels(3, G, C, seed=13)

    def jf(xx):
        return jl.compute_loss({}, {}, xx, jnp.asarray(labels))
    loss, gx = jax.jit(jax.value_and_grad(jf))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got = pl.compute_loss(xt, torch.from_numpy(labels))
    got.backward()
    _close(float(got.detach()), float(loss), what="loss")
    _close(xt.grad.numpy(), np.asarray(gx), what="grad")


def test_yolo2_host_readers_match_jax():
    jl, pl = _yolo()
    x = _x((2, G, G, A * (5 + C)), 14)
    out = np.array(jl.forward({}, {}, jnp.asarray(x))[0])
    for thr in (0.3, 0.5, 0.8):
        want = jl.get_predicted_objects(out, thr)
        got = pl.get_predicted_objects(torch.from_numpy(out), thr)
        assert [(o.example_number, o.center_x, o.center_y, o.width,
                 o.height, o.confidence, o.predicted_class) for o in got] \
            == [(o.example_number, o.center_x, o.center_y, o.width,
                 o.height, o.confidence, o.predicted_class) for o in want]
    np.testing.assert_array_equal(pl.get_confidence_matrix(out, 1, 0),
                                  jl.get_confidence_matrix(out, 1, 0))
    np.testing.assert_array_equal(pl.get_probability_matrix(out, 0, 2),
                                  jl.get_probability_matrix(out, 0, 2))
    from deeplearning4j_tpu_torch.nn.layers import non_max_suppression
    dets = pl.get_predicted_objects(out, 0.3)
    assert [o.confidence for o in non_max_suppression(dets)] == \
        [o.confidence for o in jyolo.non_max_suppression(
            jl.get_predicted_objects(out, 0.3))]


def _jax_twin(jnet, net):
    """The JAX graph carrying `net`'s params and running state, fresh
    updater state and counters, without JAX's own (slow, eager) init."""
    jnet.iteration_count = 0
    jnet.params = {k: {n: jnp.asarray(a) for n, a in v.items()}
                   for k, v in to_jax_params(net).items()}
    jnet.updater_state = {
        k: {n: (jnet.conf.nodes[k].layer.updater or JaxSgd(1e-3))
            .init_state(a) for n, a in v.items()}
        for k, v in jnet.params.items()}
    jnet.net_state = {k: {n: jnp.asarray(a) for n, a in v.items()}
                      for k, v in to_jax_state(net).items()}
    jnet._initialized = True
    return jnet


def test_small_yolo_graph_trains_as_jax():
    """`yolo2_conf` at 64x64 and 1/16 of the widths (passthrough,
    SpaceToDepth, the merge, the Yolo2 loss): output() from the port's
    init equal to JAX's; two Nesterovs steps at batch 4: step 0's loss
    within ATOL, step 1's loss and the params within NOISE_FACTOR x
    JAX's distance to its noisy twin (plus ATOL)."""
    conf = chip_smoke.yolo2_conf(64, C, width=1 / 16, lr=1e-3)
    net = ComputationGraph(conf, device="cpu").init(21)
    jnet = _jax_twin(JaxGraph(JaxGraphConf.from_json(conf.to_json())), net)
    x = _x((8, 64, 64, 3), 22)
    labels = chip_smoke.yolo_labels(8, 2, C, seed=23)
    _close(net.output(x[:4]).numpy(), np.asarray(jnet.output(x[:4])),
           what="output")
    # the noisy twin first, on the same JAX net (one compiled step)
    noisy = x * (1 + NOISE * _x(x.shape, 24))
    ref = []
    for i in (0, 4):
        jnet.fit(JaxDataSet(noisy[i:i + 4], labels[i:i + 4]))
        ref.append(float(jnet.score_value))
    twin_params = {k: {n: np.asarray(a) for n, a in v.items()}
                   for k, v in jnet.params.items()}
    jnet = _jax_twin(jnet, net)
    got, want = [], []
    for i in (0, 4):
        net.fit(DataSet(x[i:i + 4], labels[i:i + 4]))
        jnet.fit(JaxDataSet(x[i:i + 4], labels[i:i + 4]))
        got.append(net.score_value)
        want.append(float(jnet.score_value))
    _close(got[0], want[0], what="step 0 loss")
    assert abs(got[1] - want[1]) <= NOISE_FACTOR * abs(ref[1] - want[1]) \
        + ATOL * abs(want[1])
    num = den = self_num = 0.0
    for key, lp in to_jax_params(net).items():
        for name, a in lp.items():
            w = np.asarray(jnet.params[key][name], np.float64)
            num += float(((a - w) ** 2).sum())
            self_num += float(((twin_params[key][name] - w) ** 2).sum())
            den += float((w ** 2).sum())
    assert np.sqrt(num / den) <= NOISE_FACTOR * np.sqrt(self_num / den) \
        + ATOL
