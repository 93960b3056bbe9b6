"""The port's convolutional layers against the JAX package's, on the CPU:
`ConvolutionLayer`, `SubsamplingLayer`, `ZeroPaddingLayer`,
`BatchNormalization`, `ActivationLayer` and `GlobalPoolingLayer` over
NHWC, forward and gradient (`jax.grad` of ``sum(y * r)`` for a seeded
cotangent r, against `torch.autograd`), from the same numpy inputs and
JAX-initialised params; and BatchNormalization's running state in a
MultiLayerNetwork (`fit`, `net_state`, the zip, both ways).

Tolerances: fp32 results within ATOL = 1e-5 of JAX's relative to the
largest |value| of the reference (convolutions sum up to 7 x 7 x 3
products in another order); under `mixed_bf16` BatchNormalization is
held to the bf16 band, BF16_TOL = 2^-6 of the largest |value| (JAX
rounds the mean, the inverse deviation and gamma/beta to bf16 before it
normalizes, the port's `F.batch_norm` keeps them fp32 and rounds once),
and its running statistics, fp32 on both sides, to ATOL.
"""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.common.updaters import Nesterovs as JaxNesterovs
from deeplearning4j_tpu.nn.conf.builder import (
    NeuralNetConfiguration as JaxBuilder,
)
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.layers import convolution as jconv
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.layers import normalization as jnorm
from deeplearning4j_tpu.nn.layers import pooling as jpool
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.util.serializer import ModelSerializer as JaxZip
from deeplearning4j_tpu_torch.common import prng
from deeplearning4j_tpu_torch.common.updaters import Nesterovs
from deeplearning4j_tpu_torch.kernels.fused_adam import _dense
from deeplearning4j_tpu_torch.nn.conf.builder import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    ActivationLayer,
    ConvolutionLayer,
    GlobalPoolingLayer,
    SubsamplingLayer,
    ZeroPaddingLayer,
    layer_from_dict,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.jax_params import (
    from_jax_params,
    from_jax_state,
    to_jax_params,
    to_jax_state,
    to_jax_updater_state,
    to_numpy_params,
)
from deeplearning4j_tpu_torch.util.serializer import ModelSerializer

ATOL = 1e-5
BF16_TOL = 2.0 ** -6
H, W = 13, 11          # odd sizes: SAME pads unevenly at stride 2


@pytest.fixture(autouse=True)
def _no_env_policy(monkeypatch):
    monkeypatch.delenv("DL4J_DTYPE_POLICY", raising=False)


def _close(got, want, tol=ATOL, what=""):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max abs err {err} (tol {tol})"


def _inputs(seed, c=3, b=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, H, W, c)).astype(np.float32)


def _pair(jl, x, seed=1, state=None, train=False):
    """JAX and port forward and gradient of sum(y * r) in x and the
    params: (y, {name: grad}) for each side. The port layer is built
    from the JAX layer's `to_dict()` (which it must write back) and
    carries the JAX layer's params."""
    pl = layer_from_dict(jl.to_dict())
    assert pl.to_dict() == jl.to_dict()
    params = jl.init_params(jax.random.PRNGKey(seed))
    pl.load_jax_params({k: np.asarray(v) for k, v in params.items()})
    st = jl.init_state() if state is None else state
    if st:
        pl.load_jax_state({k: np.asarray(v) for k, v in st.items()})
    y0, _ = jl.forward(params, st, jnp.asarray(x), train=train)
    r = np.random.default_rng(seed + 7).standard_normal(
        np.shape(y0)).astype(np.float32)

    def jf(p, xx):
        y, _ = jl.forward(p, st, xx, train=train)
        return jnp.sum(y * r)
    gp, gx = jax.grad(jf, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    pmap = pl.jax_param_map()
    for t in pmap.values():
        t.requires_grad_(True)
    y = pl(xt, train=train)
    (y * torch.from_numpy(r)).sum().backward()
    want = {"x": gx, **gp}
    got = {"x": xt.grad, **{k: t.grad for k, t in pmap.items()}}
    return (y.detach(), got), (y0, want), pl


def _check_pair(jl, x, tol=ATOL, **kw):
    (y, g), (y0, g0), pl = _pair(jl, x, **kw)
    _close(y, y0, tol, "forward")
    assert set(g) == set(g0)
    for k in g0:
        _close(g[k], g0[k], tol, f"grad {k}")
    return pl


# -------------------------------------------------------------- convolution
CONV_CASES = [
    # mode, kernel, stride, dilation, bias
    ("truncate", 1, 1, 1, True), ("truncate", 3, 1, 1, False),
    ("truncate", 3, 2, 1, True), ("truncate", 7, 2, 1, False),
    ("truncate", 3, 1, 2, True), ("same", 1, 2, 1, False),
    ("same", 3, 1, 1, True), ("same", 3, 2, 1, False),
    ("same", 7, 2, 1, True), ("same", 3, 2, 2, True),
    ("strict", 3, 2, 1, True), ("strict", 7, 2, 1, False),
    ("strict", 1, 2, 1, True), ("strict", 3, 2, 2, False),
]


@pytest.mark.parametrize("mode,k,s,d,bias", CONV_CASES)
def test_convolution_matches_jax(mode, k, s, d, bias):
    pad = (k - 1) // 2 * d
    jl = jconv.ConvolutionLayer(n_in=3, n_out=5, kernel_size=k, stride=s,
                                padding=pad, dilation=d,
                                convolution_mode=mode, has_bias=bias,
                                activation="tanh")
    pl = _check_pair(jl, _inputs(3))
    assert pl.get_output_type(InputType.convolutional(H, W, 3)).to_dict() \
        == jl.get_output_type(JaxInputType.convolutional(H, W, 3)).to_dict()


def test_strict_mode_refuses_an_uneven_window():
    pl = ConvolutionLayer(n_in=3, n_out=2, kernel_size=2, stride=2,
                          convolution_mode="strict")
    with pytest.raises(ValueError, match="STRICT"):
        pl.get_output_type(InputType.convolutional(H, W, 3))


def test_convolution_weight_is_hwio_over_channels_last_memory():
    """W has the JAX name and HWIO shape; its memory is OHWI, so the OIHW
    view cuDNN takes is channels_last (no copy); the updater's slots
    and a dtype copy keep that layout, and fused Adam walks it flat."""
    pl = ConvolutionLayer(n_in=3, n_out=8, kernel_size=(3, 5))
    assert tuple(pl.W.shape) == (3, 5, 3, 8)
    oihw = pl.W.permute(3, 2, 0, 1)
    assert oihw.is_contiguous(memory_format=torch.channels_last)
    assert Nesterovs(0.1).init_state(pl.W)["v"].stride() == pl.W.stride()
    assert pl.W.detach().to(torch.bfloat16).stride() == pl.W.stride()
    assert _dense(pl.W) and not _dense(torch.zeros(4, 6)[:, :3])
    pl.init_weights(prng.key(0))
    std = float(pl.W.std())                   # RELU-less XAVIER default
    assert 0.5 < std / (2.0 / (3 * 15 + 8 * 15)) ** 0.5 < 1.5


# ------------------------------------------------------------- subsampling
POOL_CASES = [
    # kernel, stride, mode, padding
    (3, 2, "same", 0), (3, 1, "same", 0), (2, 2, "same", 0),
    (2, 2, "truncate", 1), (3, 3, "truncate", 0),
]


@pytest.mark.parametrize("pooling", ["max", "avg", "sum", "pnorm"])
@pytest.mark.parametrize("k,s,mode,pad", POOL_CASES)
def test_subsampling_matches_jax(pooling, k, s, mode, pad):
    x = _inputs(4)
    if pooling == "pnorm":
        x = np.abs(x) + 0.1       # |x|^p's gradient at 0 differs by side
    jl = jconv.SubsamplingLayer(pooling_type=pooling, kernel_size=k,
                                stride=s, padding=pad, convolution_mode=mode,
                                pnorm=3)
    _check_pair(jl, x)


def test_avg_divides_by_real_cells_and_max_pads_with_minus_inf():
    """The stem pool's uneven SAME padding at 112 -> 56 is (0, 1); AVG's
    edge windows count only their real cells, MAX ignores the pad even
    for all-negative inputs."""
    x = -np.ones((1, 4, 4, 1), np.float32)
    avg = SubsamplingLayer(pooling_type="avg", kernel_size=3, stride=2,
                           convolution_mode="same")
    mx = SubsamplingLayer(pooling_type="max", kernel_size=3, stride=2,
                          convolution_mode="same")
    assert np.all(avg(torch.from_numpy(x)).numpy() == -1.0)
    assert np.all(mx(torch.from_numpy(x)).numpy() == -1.0)


# ------------------------------------------------------------ zero padding
@pytest.mark.parametrize("pad", [1, (1, 2), ((0, 1), (2, 0))])
def test_zero_padding_matches_jax(pad):
    jl = jconv.ZeroPaddingLayer(pad=pad)
    _check_pair(jl, _inputs(5))
    assert ZeroPaddingLayer(pad=pad).get_output_type(
        InputType.convolutional(H, W, 3)).to_dict() == \
        jl.get_output_type(JaxInputType.convolutional(H, W, 3)).to_dict()


# -------------------------------------------------------------- batch norm
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("lock", [False, True])
def test_batch_norm_matches_jax(train, lock):
    x = _inputs(6, c=4) * 3 + 1
    jl = jnorm.BatchNormalization(n_out=4, decay=0.8, eps=1e-3,
                                  gamma_init=1.5, beta_init=0.2,
                                  lock_gamma_beta=lock, activation="relu")
    rng = np.random.default_rng(9)
    state = {"mean": jnp.asarray(rng.standard_normal(4), jnp.float32),
             "var": jnp.asarray(rng.random(4) + 0.5, jnp.float32)}
    pl = _check_pair(jl, x, state=state, train=train)
    if train:
        _, want = jl.forward(jl.init_params(None), state, jnp.asarray(x),
                             train=True)
        got = {}
        pl(torch.from_numpy(x), train=True, new_state=got)
        for k in ("mean", "var"):
            _close(got[k], want[k], ATOL, k)
        # the population variance, not torch.var's default correction=1
        batch = x.reshape(-1, 4)
        np.testing.assert_allclose(
            (got["var"].numpy() - 0.8 * np.asarray(state["var"])) / 0.2,
            batch.var(axis=0), rtol=1e-4)


@pytest.mark.parametrize("train", [False, True])
def test_batch_norm_mixed_bf16_within_the_band(train):
    """Under mixed_bf16 both sides get bf16 x and bf16 gamma/beta; the
    statistics are fp32 on both, the outputs agree to the bf16 band."""
    from deeplearning4j_tpu.nd.dtype import mixed_bf16 as jax_mixed
    x = _inputs(7, c=4) * 2 + 0.5
    jl = jnorm.BatchNormalization(n_out=4, gamma_init=1.2, beta_init=-0.1)
    pl = layer_from_dict(jl.to_dict())
    params = jl.init_params(None)
    st = jl.init_state()
    jp = jax_mixed().cast_params(params)
    y0, st0 = jl.forward(jp, st, jnp.asarray(x, jnp.bfloat16), train=train)
    assert y0.dtype == jnp.bfloat16
    got = {}
    with torch.no_grad():
        pl.gamma.copy_(torch.tensor(np.asarray(params["gamma"])))
        pl.beta.copy_(torch.tensor(np.asarray(params["beta"])))
    copies = {n: p.detach().to(torch.bfloat16)
              for n, p in pl.named_parameters()}
    y = torch.func.functional_call(
        pl, copies, (torch.tensor(x).to(torch.bfloat16),),
        dict(train=train, new_state=got))
    assert y.dtype == torch.bfloat16
    _close(y.float(), np.asarray(y0, np.float32), BF16_TOL, "mixed forward")
    if train:
        for k in ("mean", "var"):
            assert got[k].dtype == torch.float32
            _close(got[k], st0[k], ATOL, f"mixed {k}")


def test_activation_layer_matches_jax():
    jl = jff.ActivationLayer(activation="relu")
    _check_pair(jl, _inputs(8))
    assert ActivationLayer().to_dict() == jff.ActivationLayer().to_dict()


@pytest.mark.parametrize("pooling", ["max", "avg", "sum", "pnorm"])
def test_global_pooling_over_nhwc_matches_jax(pooling):
    x = np.abs(_inputs(10)) + 0.1
    jl = jpool.GlobalPoolingLayer(pooling_type=pooling, pnorm=2)
    _check_pair(jl, x)
    assert GlobalPoolingLayer().get_output_type(
        InputType.convolutional(H, W, 3)).to_dict() == \
        jl.get_output_type(JaxInputType.convolutional(H, W, 3)).to_dict()


@pytest.mark.parametrize("name", ["convolution1d", "space_to_depth",
                                  "upsampling2d",
                                  "separable_convolution2d",
                                  "zeropadding1d"])
def test_unported_layers_are_refused_by_name(name):
    """These layers were refused by name until they were ported; each
    now builds from its name and writes its dict back (their parity
    with JAX: tests/test_torch_port_layers_rest.py), and a name outside
    the registry still raises."""
    layer = layer_from_dict({"layer_name": name})
    assert layer.layer_name == name
    assert layer_from_dict(layer.to_dict()).to_dict() == layer.to_dict()
    with pytest.raises(KeyError):
        layer_from_dict({"layer_name": name + "_unknown"})


# --------------------------------------- batch norm in a MultiLayerNetwork
def _cnn_conf():
    """conv -> BN -> max pool -> conv -> BN -> global avg -> output, over
    [8, 8, 2] images, Nesterovs with l2, as a JAX layer list."""
    return (JaxBuilder.builder().seed(3).updater(JaxNesterovs(0.05, 0.9))
            .weight_init("relu").l2(1e-4).list()
            .layer(jconv.ConvolutionLayer(n_out=4, kernel_size=3,
                                          convolution_mode="same",
                                          has_bias=False))
            .layer(jnorm.BatchNormalization(activation="relu"))
            .layer(jconv.SubsamplingLayer(kernel_size=3, stride=2,
                                          convolution_mode="same"))
            .layer(jconv.ConvolutionLayer(n_out=6, kernel_size=1,
                                          stride=2))
            .layer(jnorm.BatchNormalization(activation="relu"))
            .layer(jpool.GlobalPoolingLayer(pooling_type="avg"))
            .layer(jff.OutputLayer(n_out=3))
            .set_input_type(JaxInputType.convolutional(8, 8, 2)).build())


def _cnn_data(seed, n=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 8, 8, 2)).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]


def test_batch_norm_state_in_a_layer_list_trains_as_jax(tmp_path):
    """A CNN layer list with two BatchNormalizations: 3 `fit` steps from
    JAX's init against JAX's `fit` (loss, params, Nesterov's v and the
    running state within 1e-5 relative), `net_state` keyed "<i>"; its
    zip carries state.npz, restores in the JAX package and back."""
    jconf = _cnn_conf()
    jnet = JaxNet(jconf).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu")
    assert net.conf.to_dict() == jconf.to_dict()
    from_jax_params(net, to_numpy_params(jnet.params))
    from_jax_state(net, to_numpy_params(jnet.net_state))
    assert set(net.net_state) == set(jnet.net_state) == {"1", "4"}
    x, y = _cnn_data(1, 12)
    jnet.fit(x, y, batch_size=4, shuffle=False)
    net.fit(x, y, batch_size=4, shuffle=False)
    np.testing.assert_allclose(net.score_value, jnet.score_value, rtol=1e-5)
    for got, want in ((to_jax_params(net), jnet.params),
                      (to_jax_state(net), jnet.net_state)):
        for k, lv in want.items():
            for n, a in lv.items():
                _close(got[k][n], a, 1e-5, f"{k}/{n}")
    for k, lv in jnet.updater_state.items():
        for n, st in lv.items():
            _close(to_jax_updater_state(net)[k][n]["v"], st["v"], 1e-5,
                   f"v {k}/{n}")
    path = tmp_path / "cnn.zip"
    ModelSerializer.write_model(net, path)
    back = JaxZip.restore_model(path)
    for k, lv in jnet.net_state.items():
        for n, a in lv.items():
            np.testing.assert_array_equal(np.asarray(back.net_state[k][n]),
                                          to_jax_state(net)[k][n])
    JaxZip.write_model(jnet, tmp_path / "jax.zip")
    port = ModelSerializer.restore_model(tmp_path / "jax.zip", device="cpu")
    xe, _ = _cnn_data(2, 4)
    _close(port.output(xe), jnet.output(xe), 1e-5, "restored output()")


def test_running_state_updates_once_a_step_and_never_in_inference():
    """`score()` and `output()` leave the running state alone, and a step
    writes it once, after the update; it moves with `.to()` and bumps no
    params version."""
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        _cnn_conf().to_json()), device="cpu").init()
    x, y = _cnn_data(3, 4)
    from deeplearning4j_tpu_torch.datasets import DataSet
    before = to_jax_state(net)
    version = net.params_version
    net.output(x)
    net.score(DataSet(x, y))
    assert all(np.array_equal(to_jax_state(net)[k][n], before[k][n])
               for k in before for n in before[k])
    assert net.params_version == version
    with torch.no_grad():
        h = net.layers[0](torch.from_numpy(x))    # the step's own forward
        var, mean = torch.var_mean(h, dim=(0, 1, 2), correction=0)
    net.fit(x, y, batch_size=4)
    after = to_jax_state(net)
    for k, batch in (("mean", mean), ("var", var)):
        np.testing.assert_allclose(
            after["1"][k], 0.9 * before["1"][k] + 0.1 * batch.numpy(),
            rtol=1e-5, atol=1e-6)
    assert "layers.1.mean" in dict(net.named_buffers())
