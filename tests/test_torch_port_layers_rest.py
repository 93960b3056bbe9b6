"""The port's remaining layer types against the JAX package's, on the CPU:
`Convolution1DLayer`, `Subsampling1DLayer`, `Upsampling1D/2D`,
`ZeroPadding1DLayer`, `SpaceToDepthLayer`, `SeparableConvolution2D`,
`FrozenLayer`, `ReshapeLayer`, `PermuteLayer`, `PoolHelperLayer`,
`LossLayer` and `MultiHeadAttention` with `n_out != n_in`: forward and
gradients (of ``sum(y * r)`` for a seeded cotangent r) in fp32 and the
forward in bf16, `forward_mask`, serde; every layer type of the JAX
registry builds in the port, its configuration round-trips both ways,
and nets holding every new type round-trip through the model zip both
ways with JAX's `init(seed)`; a frozen conv and BatchNorm stay bit-equal
through `fit`; and a JAX zip saved with `pretrain(True)` trains in the
port.

Tolerances: fp32 within ATOL = 1e-5 of the largest |value| of JAX's
result; bf16 within BF16_ULPS = 2 bf16 ulps of the largest |value| of
each JAX result (both sides round each product sum once to bf16);
`init(seed)` within INIT_RTOL = 1e-5 of each tensor's largest value
(the normal draws go through erfinv, equal to JAX's within its last
place).
"""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.common.updaters import Sgd as JaxSgd
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.nn.conf.builder import (
    NeuralNetConfiguration as JaxBuilder,
)
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.layers import attention as jatt
from deeplearning4j_tpu.nn.layers import convolution as jconv
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.layers import misc as jmisc
from deeplearning4j_tpu.nn.layers import moe as jmoe
from deeplearning4j_tpu.nn.layers import normalization as jnorm
from deeplearning4j_tpu.nn.layers import rbm as jrbm
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu.nn.layers import variational as jvae
from deeplearning4j_tpu.nn.layers.base import _LAYER_REGISTRY as JAX_LAYERS
from deeplearning4j_tpu.nn.layers.base import layer_from_dict as jax_from_dict
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.util.serializer import ModelSerializer as JaxZip
from deeplearning4j_tpu_torch import nn as _nn  # noqa: F401
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf.builder import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import base as pbase
from deeplearning4j_tpu_torch.nn.layers import layer_from_dict
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.jax_params import (
    to_jax_params,
    to_jax_state,
    to_numpy_params,
)
from deeplearning4j_tpu_torch.util.serializer import ModelSerializer

ATOL = 1e-5
BF16_ULPS = 2
INIT_RTOL = 1e-5
B, T, F, H, W, C = 2, 9, 4, 6, 6, 3


@pytest.fixture(autouse=True)
def _no_env_policy(monkeypatch):
    monkeypatch.delenv("DL4J_DTYPE_POLICY", raising=False)


def _close(got, want, tol=ATOL, what=""):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, f"{what}: max abs err {err} (tol {tol})"


def bf16_ulp(a):
    a = max(float(np.abs(np.asarray(a, np.float64)).max()), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# {case: (JAX layer, input shape)}
CASES = {
    "upsampling2d": (jconv.Upsampling2D(size=(2, 3)), (B, H, W, C)),
    "zeropadding1d": (jconv.ZeroPadding1DLayer(pad=(1, 2)), (B, T, F)),
    "space_to_depth": (jconv.SpaceToDepthLayer(block_size=2), (B, H, W, C)),
    "upsampling1d": (jconv.Upsampling1D(size=3), (B, T, F)),
    "conv1d_truncate": (jconv.Convolution1DLayer(
        n_in=F, n_out=5, kernel_size=3, stride=2, padding=1,
        activation="tanh"), (B, T, F)),
    "conv1d_same_dilated": (jconv.Convolution1DLayer(
        n_in=F, n_out=5, kernel_size=3, stride=2, dilation=2,
        convolution_mode="same"), (B, T, F)),
    "subsampling1d_max": (jconv.Subsampling1DLayer(
        kernel_size=3, stride=2, padding=1), (B, T, F)),
    "subsampling1d_avg_same": (jconv.Subsampling1DLayer(
        pooling_type="avg", kernel_size=2, stride=2,
        convolution_mode="same"), (B, T, F)),
    "separable_dm2": (jconv.SeparableConvolution2D(
        n_in=C, n_out=4, kernel_size=(3, 3), padding=(1, 1),
        depth_multiplier=2, activation="relu"), (B, H, W, C)),
    "separable_same_stride2": (jconv.SeparableConvolution2D(
        n_in=C, n_out=4, kernel_size=(3, 2), stride=(2, 2),
        depth_multiplier=3, convolution_mode="same", has_bias=False),
        (B, H + 1, W, C)),
    "frozen_conv": (jmisc.FrozenLayer(layer=jconv.ConvolutionLayer(
        n_in=C, n_out=4, kernel_size=(3, 3))), (B, H, W, C)),
    "reshape": (jmisc.ReshapeLayer(target_shape=(T * F,)), (B, T, F)),
    "permute": (jmisc.PermuteLayer(dims=(2, 1)), (B, T, F)),
    "permute3": (jmisc.PermuteLayer(dims=(3, 1, 2)), (B, H, W, C)),
    "pool_helper": (jmisc.PoolHelperLayer(), (B, H, W, C)),
    "loss_layer": (jff.LossLayer(activation="softmax"), (B, F)),
    "mha_n_out": (jatt.MultiHeadAttention(n_in=F, n_out=8, n_heads=2,
                                          causal=True), (B, T, F)),
}


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _pair(jl, x, dtype=jnp.float32, seed=1, grads=True):
    """JAX and port forward and, with `grads`, the gradients of
    sum(y * r) in x and the params: ((y, {name: grad}), (y0, {name:
    grad})). The port layer is built from the JAX layer's `to_dict()`,
    which it must write back, and carries the JAX params (cast to
    `dtype` on both sides, as a mixed policy's copies are). JAX's side
    is jitted (eager dispatch of each op costs more than the compile)."""
    pl = layer_from_dict(jl.to_dict())
    assert json.dumps(pl.to_dict()) == json.dumps(jl.to_dict())
    params = jl.init_params(jax.random.PRNGKey(seed))
    pl.load_jax_params({k: np.asarray(v) for k, v in params.items()})
    params = jax.tree_util.tree_map(lambda a: a.astype(dtype), params)
    xj = jnp.asarray(x).astype(dtype)
    y0 = jax.jit(lambda p, xx: jl.forward(p, {}, xx)[0])(params, xj)
    r = _x(np.shape(y0), seed + 7)
    td = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    pl.to(td)
    xt = torch.tensor(_f32(xj)).to(td).requires_grad_(grads)
    pmap = pl.jax_param_map()
    for t in pmap.values():
        t.requires_grad_(grads)
    y = pl(xt)
    if not grads:
        return (y.detach().float().numpy(), {}), (_f32(y0), {})

    def jf(p, xx):
        return jnp.sum(jl.forward(p, {}, xx)[0].astype(jnp.float32) * r)
    gp, gx = jax.jit(jax.grad(jf, argnums=(0, 1)))(params, xj)
    (y.float() * torch.from_numpy(r)).sum().backward()
    got = {"x": xt.grad, **{k: (torch.zeros_like(t) if t.grad is None
                                else t.grad) for k, t in pmap.items()}}
    return ((y.detach().float().numpy(),
             {k: v.float().numpy() for k, v in got.items()}),
            (_f32(y0), {"x": _f32(gx), **{k: _f32(v)
                                          for k, v in gp.items()}}))


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_gradients_match_jax_fp32(case):
    jl, shape = CASES[case]
    (y, g), (y0, g0) = _pair(jl, _x(shape))
    _close(y, y0, what=f"{case} forward")
    assert set(g) == set(g0)
    for k in g0:
        _close(g[k], g0[k], what=f"{case} grad {k}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax_bf16(case):
    """The forward on bf16 params and inputs (a mixed_bf16 step's
    copies) within BF16_ULPS of the largest |y|."""
    jl, shape = CASES[case]
    (y, _), (y0, _) = _pair(jl, _x(shape), dtype=jnp.bfloat16, grads=False)
    err = float(np.abs(y - y0).max())
    assert err <= BF16_ULPS * bf16_ulp(y0), (case, err, bf16_ulp(y0))


@pytest.mark.parametrize("case", ["conv1d_truncate", "conv1d_same_dilated",
                                  "subsampling1d_max", "upsampling1d",
                                  "zeropadding1d"])
def test_forward_mask_matches_jax(case):
    jl, _ = CASES[case]
    pl = layer_from_dict(jl.to_dict())
    mask = np.ones((3, T), np.float32)
    mask[0, 5:] = 0
    mask[1, :2] = 0
    mask[2, 1::3] = 0
    want = jl.forward_mask(jnp.asarray(mask), None)
    got = pl.forward_mask(torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_output_types_match_jax():
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    for case, (jl, shape) in CASES.items():
        it = (JaxInputType.recurrent(F, T) if len(shape) == 3 else
              JaxInputType.convolutional(*shape[1:]) if len(shape) == 4
              else JaxInputType.feed_forward(F))
        pl = layer_from_dict(jl.to_dict())
        got = pl.get_output_type(InputType.from_dict(it.to_dict()))
        assert got.to_dict() == jl.get_output_type(it).to_dict(), case


# ------------------------------------------------------------- registry
@pytest.mark.parametrize("name", sorted(JAX_LAYERS))
def test_every_jax_layer_type_builds_and_round_trips(name):
    """Each layer_name of the JAX registry builds in the port from its
    JAX default configuration, and each side reads the other's dict
    back to the same dict."""
    jd = (JAX_LAYERS[name]().to_dict() if name != "frozen" else
          jmisc.FrozenLayer(layer=jff.DenseLayer(n_in=3, n_out=2)).to_dict())
    pl = layer_from_dict(jd)
    assert pl.layer_name == name
    assert json.dumps(pl.to_dict()) == json.dumps(jd)
    assert json.dumps(jax_from_dict(pl.to_dict()).to_dict()) == \
        json.dumps(jd)


def test_unknown_layer_names_still_raise():
    with pytest.raises(KeyError):
        layer_from_dict({"layer_name": "no_such_layer"})
    assert not hasattr(pbase, "NOT_PORTED")


# ------------------------------------------------------ nets and the zip
def _rnn_conf():
    return (JaxBuilder.builder().seed(5).updater(JaxSgd(0.1)).list()
            .layer(jconv.Convolution1DLayer(n_out=6, kernel_size=3,
                                            convolution_mode="same"))
            .layer(jconv.Subsampling1DLayer(kernel_size=2, stride=1))
            .layer(jconv.ZeroPadding1DLayer(pad=1))
            .layer(jconv.Upsampling1D(size=2))
            .layer(jatt.MultiHeadAttention(n_out=8, n_heads=2))
            .layer(jrec.RnnOutputLayer(n_out=3, activation="softmax"))
            .set_input_type(JaxInputType.recurrent(F, T)).build())


def _cnn_conf():
    return (JaxBuilder.builder().seed(6).updater(JaxSgd(0.1)).list()
            .layer(jconv.SeparableConvolution2D(n_out=4, kernel_size=(3, 3),
                                                depth_multiplier=2,
                                                padding=(1, 1)))
            .layer(jconv.Upsampling2D(size=2))
            .layer(jconv.SpaceToDepthLayer(block_size=2))
            .layer(jmisc.PoolHelperLayer())
            .layer(jmisc.FrozenLayer(layer=jconv.ConvolutionLayer(
                n_in=16, n_out=5, kernel_size=(2, 2))))
            .layer(jmisc.FrozenLayer(layer=jnorm.BatchNormalization(n_out=5)))
            .layer(jmisc.PermuteLayer(dims=(2, 1, 3)))
            .layer(jmisc.ReshapeLayer(target_shape=(4 * 4 * 5,)))
            .layer(jff.DenseLayer(n_out=3, activation="identity"))
            .layer(jff.LossLayer(activation="softmax"))
            .set_input_type(JaxInputType.convolutional(H, W, C)).build())


def _ff_conf():
    """The unsupervised and MoE layers as a supervised stack."""
    return (JaxBuilder.builder().seed(7).updater(JaxSgd(0.1)).list()
            .layer(jff.AutoEncoder(n_out=8))
            .layer(jrbm.RBM(n_out=7))
            .layer(jvae.VariationalAutoencoder(
                n_out=5, encoder_layer_sizes=(6,), decoder_layer_sizes=(6,)))
            .layer(jmoe.MixtureOfExperts(n_out=3, n_experts=3,
                                         hidden_size=4))
            .layer(jff.LossLayer(activation="softmax"))
            .set_input_type(JaxInputType.feed_forward(F)).build())


NETS = {"rnn": (_rnn_conf, (B, T, F), (B, 2 * (T - 1 + 2), 3)),
        "cnn": (_cnn_conf, (B, H, W, C), (B, 3)),
        "ff": (_ff_conf, (B, F), (B, 3))}


def _labels(shape, seed):
    idx = np.random.default_rng(seed).integers(0, shape[-1], shape[:-1])
    return np.eye(shape[-1], dtype=np.float32)[idx]


@pytest.mark.parametrize("net", sorted(NETS))
def test_init_and_zip_round_trips_match_jax(net, tmp_path):
    """`init(seed)` equals JAX's; a JAX-written zip restores in the port
    (output within ATOL of JAX's) and the port's zip restores in JAX
    (params bit-equal, output within ATOL)."""
    make, xs, _ = NETS[net]
    jconf = make()
    jnet = JaxNet(jconf).init(17)
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init(17)
    jp = to_numpy_params(jnet.params)
    for key, layer in pnet.keyed():
        for name, t in layer.jax_param_map().items():
            want = jp[key][name]
            err = np.abs(t.numpy() - want).max() / max(np.abs(want).max(),
                                                       1e-30)
            assert err <= INIT_RTOL, (key, name, err)
    x = _x(xs, 3)
    JaxZip.write_model(jnet, tmp_path / "j.zip")
    restored = ModelSerializer.restore_model(tmp_path / "j.zip", device="cpu")
    _close(restored.output(x).numpy(), np.asarray(jnet.output(x)),
           what="JAX zip in the port")
    ModelSerializer.write_model(restored, tmp_path / "p.zip")
    back = JaxZip.restore_model(tmp_path / "p.zip")
    for key, lp in to_jax_params(restored).items():
        for name, a in lp.items():
            np.testing.assert_array_equal(np.asarray(back.params[key][name]),
                                          a)
    _close(restored.output(x).numpy(), np.asarray(back.output(x)),
           what="port zip in JAX")


@pytest.mark.parametrize("net", sorted(NETS))
def test_fit_matches_jax_and_frozen_stays_bit_equal(net):
    """Two Sgd steps of each net in both packages from JAX's init: the
    losses and params within ATOL; the frozen conv and BatchNorm params
    and running statistics bit-equal to their start."""
    make, xs, ys = NETS[net]
    jconf = make()
    jnet = JaxNet(jconf).init(19)
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init(19)
    from deeplearning4j_tpu_torch.util.jax_params import from_jax_params
    from_jax_params(pnet, to_numpy_params(jnet.params))
    start, state0 = to_jax_params(pnet), to_jax_state(pnet)
    x, y = _x((2 * xs[0],) + xs[1:], 4), _labels((2 * ys[0],) + ys[1:], 5)
    for i in range(0, 2 * xs[0], xs[0]):
        jnet.fit(JaxDataSet(x[i:i + xs[0]], y[i:i + xs[0]]))
        pnet.fit(DataSet(x[i:i + xs[0]], y[i:i + xs[0]]))
        _close(pnet.score_value, float(jnet.score_value), what="loss")
    got = to_jax_params(pnet)
    for key, lp in got.items():
        for name, a in lp.items():
            _close(a, np.asarray(jnet.params[key][name]),
                   what=f"{key} {name}")
            frozen = pnet.layers[int(key)].layer_name == "frozen"
            if frozen:
                assert np.array_equal(a, start[key][name]), (key, name)
    for key, st in to_jax_state(pnet).items():
        for name, a in st.items():
            assert np.array_equal(a, state0[key][name]), (key, name)


def test_frozen_layer_bit_equal_under_mixed_bf16():
    """A frozen conv and BatchNorm in a mixed_bf16 net: after 3 fit steps
    their fp32 master params and running statistics are bit-equal to
    their start, the trained layers moved, and they hold no updater
    state."""
    jconf = _cnn_conf()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu", dtype_policy="mixed_bf16").init(23)
    start, state0 = to_jax_params(pnet), to_jax_state(pnet)
    x, y = _x((6, H, W, C), 6), _labels((6, 3), 7)
    for i in range(0, 6, 2):
        pnet.fit(DataSet(x[i:i + 2], y[i:i + 2]))
    after = to_jax_params(pnet)
    for key, layer in pnet.keyed():
        for name in layer.jax_param_map():
            same = np.array_equal(after[key][name], start[key][name])
            assert same == (layer.layer_name == "frozen"), (key, name)
            assert after[key][name].dtype == np.float32
        if layer.layer_name == "frozen":
            assert all(not st for st in pnet.updater_state[key].values())
    for key, st in to_jax_state(pnet).items():
        for name, a in st.items():
            assert np.array_equal(a, state0[key][name])


def test_yolo_graph_zip_round_trips_both_ways(tmp_path):
    """A passthrough graph (a conv, SpaceToDepth of it merged with a
    strided conv, the Yolo2 head): JAX's zip restores in the port
    (output within ATOL of JAX's) and the port's zip restores in JAX
    (params bit-equal, output within ATOL)."""
    from deeplearning4j_tpu.nn.conf.graph import MergeVertex
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
    from deeplearning4j_tpu.nn.graph import (
        ComputationGraphConfiguration as JaxGraphConf)
    from deeplearning4j_tpu.nn.layers import objdetect as jyolo
    conf = (JaxGraphConf.graph_builder(JaxBuilder.builder().seed(9))
            .add_inputs("in")
            .set_input_types(JaxInputType.convolutional(8, 8, C))
            .add_layer("c1", jconv.ConvolutionLayer(
                n_out=4, kernel_size=(3, 3), convolution_mode="same"), "in")
            .add_layer("s2d", jconv.SpaceToDepthLayer(block_size=2), "c1")
            .add_layer("c2", jconv.ConvolutionLayer(
                n_out=4, kernel_size=(2, 2), stride=(2, 2)), "c1")
            .add_vertex("route", MergeVertex(), "s2d", "c2")
            .add_layer("det", jconv.ConvolutionLayer(
                n_out=2 * (5 + 2), kernel_size=(1, 1)), "route")
            .add_layer("yolo", jyolo.Yolo2OutputLayer(
                anchors=((1.0, 1.0), (2.0, 1.5))), "det")
            .set_outputs("yolo").build())
    jnet = JaxGraph(conf).init(25)
    x = _x((2, 8, 8, C), 26)
    JaxZip.write_model(jnet, tmp_path / "j.zip")
    net = ModelSerializer.restore_model(tmp_path / "j.zip", device="cpu")
    _close(net.output(x).numpy(), np.asarray(jnet.output(x)),
           what="JAX zip in the port")
    ModelSerializer.write_model(net, tmp_path / "p.zip")
    back = JaxZip.restore_model(tmp_path / "p.zip")
    for key, lp in to_jax_params(net).items():
        for name, a in lp.items():
            np.testing.assert_array_equal(np.asarray(back.params[key][name]),
                                          a)
    _close(net.output(x).numpy(), np.asarray(back.output(x)),
           what="port zip in JAX")


def test_pretrain_flag_zip_trains_in_the_port(tmp_path):
    """A JAX zip whose configuration sets `pretrain(True)` restores into
    the port (the flag round-trips) and takes a `fit` step with JAX's
    loss and params (the flag is inert in `fit`, as in JAX)."""
    jconf = (JaxBuilder.builder().seed(8).updater(JaxSgd(0.1)).list()
             .layer(jff.DenseLayer(n_out=5, activation="tanh"))
             .layer(jff.OutputLayer(n_out=3))
             .set_input_type(JaxInputType.feed_forward(F)).pretrain(True)
             .build())
    jnet = JaxNet(jconf).init()
    JaxZip.write_model(jnet, tmp_path / "pt.zip")
    net = ModelSerializer.restore_model(tmp_path / "pt.zip", device="cpu")
    assert net.conf.pretrain is True
    assert json.loads(net.conf.to_json())["pretrain"] is True
    x, y = _x((4, F), 9), _labels((4, 3), 10)
    jnet.fit(JaxDataSet(x, y))
    net.fit(DataSet(x, y))
    _close(net.score_value, float(jnet.score_value), what="loss")
    for key, lp in to_jax_params(net).items():
        for name, a in lp.items():
            _close(a, np.asarray(jnet.params[key][name]), what=name)
