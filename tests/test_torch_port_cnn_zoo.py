"""The CNN zoo of the port against the JAX package's, on the CPU:
`LocalResponseNormalization` (forward and input gradient against
`jax.grad`, fp32 and bf16), `CenterLossOutputLayer` (loss and the
gradients of W, b and cL; l2 leaves cL alone; cL crosses the zip both
ways), PNORM/MAX/AVG pooling with SAME's uneven padding at stride 2, and
the eight zoo classes: `conf().to_dict()` at their defaults; LeNet's
`init(123)`, three Adam steps, and the packaged MNIST checkpoint on the
297 held-out digits of the committed fixture; the other seven
models' `output()` at reduced input sizes with the port's params
carried into JAX, and one `fit` step of SimpleCNN and AlexNet. The
graph models' fit steps are held on the card against the CPU port
(`chip_smoke.py` phase 12): JAX compiles their training step for
minutes on the CPU.

Tolerances: fp32 values within ATOL = 1e-5 of JAX's relative to the
largest |value| (LRN within 1e-6: elementwise but for a 5-term window
sum); the init within 1e-5 of each tensor's largest |value| (erfinv's
last place); bf16 LRN within `chip_smoke.lrn_bf16_bound` (16 bf16 ulps
of the row's largest cumsum in the window, 4 ulps of the row's largest
|value| for the elementwise chain; 2 measured), the same bound on the
input gradient.
"""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from deeplearning4j_tpu import zoo as jzoo
from deeplearning4j_tpu.common.updaters import Sgd as JaxSgd
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.eval import Evaluation as JaxEvaluation
from deeplearning4j_tpu.nn.conf.builder import (
    NeuralNetConfiguration as JaxBuilder,
)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.layers import convolution as jconv
from deeplearning4j_tpu.nn.layers.normalization import (
    LocalResponseNormalization as JaxLRN,
)
from deeplearning4j_tpu.nn.layers.training import (
    CenterLossOutputLayer as JaxCenterLoss,
)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.util.serializer import ModelSerializer as JaxZip
from deeplearning4j_tpu_torch import zoo
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf.builder import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import (
    CenterLossOutputLayer,
    LocalResponseNormalization,
    layer_from_dict,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.jax_params import (
    from_jax_params,
    to_jax_params,
    to_jax_state,
    to_numpy_params,
)
from deeplearning4j_tpu_torch.util.serializer import ModelSerializer
from deeplearning4j_tpu_torch.zoo.base import WEIGHTS_DIR

ATOL = 1e-5
LRN_ATOL = 1e-6
INIT_RTOL = 1e-5
NAMES = ["LeNet", "SimpleCNN", "AlexNet", "VGG16", "VGG19", "GoogLeNet",
         "InceptionResNetV1", "FaceNetNN4Small2"]
# the reduced input sizes of the output() parity (JAX's own zoo test runs
# GoogLeNet at 64x64)
REDUCED = {
    "SimpleCNN": dict(height=16, width=16),
    "AlexNet": dict(height=96, width=96),
    "VGG16": dict(height=32, width=32, num_classes=10),
    "VGG19": dict(height=32, width=32, num_classes=10),
    "GoogLeNet": dict(height=64, width=64),
    "InceptionResNetV1": dict(height=80, width=80, blocks35=1, blocks17=1,
                              blocks8=1),
    "FaceNetNN4Small2": dict(height=64, width=64),
}


@pytest.fixture(autouse=True)
def _no_env_policy(monkeypatch):
    monkeypatch.delenv("DL4J_DTYPE_POLICY", raising=False)


def _close(got, want, tol=ATOL, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max abs err {err} (tol {tol})"


def _jax_twin(jnet, net):
    """The JAX net of the same configuration carrying `net`'s params and
    running state, with fresh updater state and without JAX's own init
    (its eager draws take most of a minute for the graph models)."""
    params = {k: {n: jnp.asarray(a) for n, a in v.items()}
              for k, v in to_jax_params(net).items()}
    updaters = {}
    for key, layer in net.keyed():
        if key in params:
            jl = (jnet.conf.nodes[key].layer if hasattr(jnet.conf, "nodes")
                  else jnet.layers[int(key)])
            u = jl.updater or JaxSgd(1e-3)
            updaters[key] = {n: u.init_state(a)
                             for n, a in params[key].items()}
    jnet.params, jnet.updater_state = params, updaters
    jnet.net_state = {k: {n: jnp.asarray(a) for n, a in v.items()}
                      for k, v in to_jax_state(net).items()}
    jnet._initialized = True
    return jnet


# ------------------------------------------------------------------- LRN
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [3, 5, 64, 192])
def test_lrn_matches_jax(C, dtype):
    """Forward and the input gradient of sum(y * r) against JAX's layer
    and `jax.grad` (inputs N(0, 9), so the window sums reach about 10 C):
    fp32 within LRN_ATOL, bf16 within the bound of the module note."""
    jl = JaxLRN()
    pl = layer_from_dict(jl.to_dict())
    assert isinstance(pl, LocalResponseNormalization)
    assert pl.to_dict() == jl.to_dict()
    rng = np.random.default_rng(C)
    x = (3 * rng.standard_normal((2, 4, 4, C))).astype(np.float32)
    r = rng.standard_normal(x.shape).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    xj = jnp.asarray(x).astype(jd)

    def fwd(xx):
        return jl.forward({}, {}, xx)[0].astype(jnp.float32)
    want = np.asarray(jax.jit(fwd)(xj))
    gwant = np.asarray(jax.jit(jax.grad(lambda xx: jnp.sum(fwd(xx) * r)))(
        xj).astype(jnp.float32))
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    y = pl(xt)
    assert y.dtype == xt.dtype
    (y.float() * torch.from_numpy(r)).sum().backward()
    got, ggot = y.detach().float().numpy(), xt.grad.float().numpy()
    if dtype == "float32":
        _close(got, want, LRN_ATOL, "forward")
        _close(ggot, gwant, LRN_ATOL, "input gradient")
        return
    xb = np.asarray(xj.astype(jnp.float32))
    for what, a, b in (("forward", got, want), ("gradient", ggot, gwant)):
        over = np.abs(a - b) / chip_smoke.lrn_bf16_bound(pl, xb, b)
        assert over.max() <= 1.0, f"{what}: {over.max()} of the bound"


# ------------------------------------------------------------ CenterLoss
def _center_pair(l2=0.0):
    jl = JaxCenterLoss(n_in=5, n_out=3, alpha=0.3, lambda_=0.05, l2=l2)
    params = jl.init_params(jax.random.PRNGKey(3))
    params["cL"] = jax.random.normal(jax.random.PRNGKey(4), (3, 5)) * 0.3
    pl = layer_from_dict(jl.to_dict())
    assert isinstance(pl, CenterLossOutputLayer)
    assert pl.to_dict() == jl.to_dict()
    assert tuple(pl.cL.shape) == (3, 5)
    pl.load_jax_params({k: np.asarray(v) for k, v in params.items()})
    return jl, params, pl


@pytest.mark.parametrize("masked", [False, True])
def test_center_loss_matches_jax(masked):
    """The loss (mcxent + 0.5 lambda mean ||x - cL[argmax y]||^2, masked
    rows zeroed) and its gradients in W, b, cL and x, as JAX's."""
    jl, params, pl = _center_pair()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]
    m = np.array([1, 1, 0, 1, 0, 1], np.float32) if masked else None

    def jf(p, xx):
        return jl.compute_loss(p, {}, xx, jnp.asarray(y), train=False,
                               mask=None if m is None else jnp.asarray(m))
    jloss = float(jf(params, jnp.asarray(x)))
    gp, gx = jax.grad(jf, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    pmap = pl.jax_param_map()
    assert list(pmap) == list(params)
    for t in pmap.values():
        t.requires_grad_(True)
    loss = pl.compute_loss(xt, torch.from_numpy(y),
                           None if m is None else torch.from_numpy(m))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=ATOL)
    _close(xt.grad, gx, what="x")
    for k, t in pmap.items():
        _close(t.grad, gp[k], what=k)
    assert np.abs(np.asarray(gp["cL"])).max() > 0


def test_center_loss_l2_leaves_the_centres_alone():
    jl, params, pl = _center_pair(l2=0.1)
    want = float(jl.regularization_score(params))
    got = float(pl.regularization_score(
        {k: t for k, t in pl.jax_param_map().items()}))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    no_c = {k: v for k, v in params.items() if k != "cL"}
    np.testing.assert_allclose(
        got, float(JaxCenterLoss(n_in=5, n_out=3, l2=0.1)
                   .regularization_score(no_c)), rtol=1e-6)


def _center_net(S, l2):
    """Dense(8, tanh) -> CenterLoss(3) through package S's layers."""
    return (JaxBuilder.builder().seed(2).updater(JaxSgd(0.2)).l2(l2).list()
            .layer(S.DenseLayer(n_in=6, n_out=8, activation="tanh"))
            .layer(S.CenterLossOutputLayer(n_in=8, n_out=3, lambda_=0.5))
            .build())


def test_center_loss_net_trains_and_crosses_the_zip_as_jax(tmp_path):
    """Two Sgd steps under l2 (which skips cL) as JAX's, cL moving; the
    port's zip restores in JAX and JAX's in the port, cL included."""
    from deeplearning4j_tpu.nn import layers as jl
    jconf = _center_net(jl, 0.05)
    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(
        jconf.to_dict()), device="cpu").init(3)
    jnet = _jax_twin(JaxNet(jconf), net)
    rng = np.random.default_rng(6)
    for _ in range(2):
        x = rng.standard_normal((8, 6)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
        jnet.fit(x, y, batch_size=8, shuffle=False)
        net.fit(x, y, batch_size=8, shuffle=False)
        np.testing.assert_allclose(net.score_value, jnet.score_value,
                                   rtol=ATOL)
    got = to_jax_params(net)
    assert np.abs(got["1"]["cL"]).max() > 0
    for k, lv in to_numpy_params(jnet.params).items():
        for n, a in lv.items():
            _close(got[k][n], a, what=f"{k}/{n}")
    path = str(tmp_path / "port.zip")
    ModelSerializer.write_model(net, path)
    back = JaxZip.restore_model(path)
    np.testing.assert_array_equal(np.asarray(back.params["1"]["cL"]),
                                  got["1"]["cL"])
    jpath = str(tmp_path / "jax.zip")
    JaxZip.write_model(jnet, jpath)
    mine = ModelSerializer.restore_model(jpath, device="cpu")
    np.testing.assert_array_equal(to_jax_params(mine)["1"]["cL"],
                                  np.asarray(jnet.params["1"]["cL"]))


# ---------------------------------------------------- pooling, SAME at /2
@pytest.mark.parametrize("mode", ["pnorm", "max", "avg"])
def test_same_stride_2_pooling_on_even_sizes_matches_jax(mode):
    """FaceNet's and GoogLeNet's 3x3/2 SAME pools on an even size pad (0,
    1): PNORM pads zeros, MAX -inf, AVG divides by the real cells;
    forward and input gradient as JAX's."""
    jl = jconv.SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2),
                                pooling_type=mode,
                                convolution_mode=jconv.ConvolutionMode.SAME)
    pl = layer_from_dict(jl.to_dict())
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 8, 6, 3)).astype(np.float32)
    y0 = jl.forward({}, {}, jnp.asarray(x))[0]
    r = rng.standard_normal(np.shape(y0)).astype(np.float32)
    gx = jax.grad(lambda xx: jnp.sum(jl.forward({}, {}, xx)[0] * r))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = pl(xt)
    (y * torch.from_numpy(r)).sum().backward()
    assert tuple(y.shape) == (2, 4, 3, 3)
    _close(y.detach(), y0, what="forward")
    _close(xt.grad, gx, what="gradient")


# ------------------------------------------------------------ the zoo
@pytest.mark.parametrize("name", NAMES)
def test_zoo_conf_equals_jax(name):
    jconf = getattr(jzoo, name)().conf()
    conf = getattr(zoo, name)().conf()
    assert conf.to_dict() == jconf.to_dict()
    assert type(conf).from_dict(jconf.to_dict()).to_dict() == jconf.to_dict()


@pytest.fixture(scope="module")
def digits():
    return chip_smoke.digits_28x28()


def test_digits_fixture_is_sklearns():
    sk = pytest.importorskip("sklearn.datasets")
    d = sk.load_digits()
    f = np.load(chip_smoke.DIGITS)
    assert f["images"].dtype == np.uint8 and f["images"].shape == (1797, 8, 8)
    np.testing.assert_array_equal(f["images"], d.images)
    np.testing.assert_array_equal(f["target"], d.target)


def test_digit_upscale_matches_jax_image_resize():
    f = np.load(chip_smoke.DIGITS)
    x = f["images"].astype(np.float32) / 16.0
    want = np.asarray(jax.image.resize(jnp.asarray(x), (len(x), 28, 28),
                                       "bilinear"))
    order = np.random.default_rng(0).permutation(len(x))
    got = chip_smoke.digits_28x28()[0][..., 0]
    assert np.abs(got - want[order]).max() <= 1e-6


def test_lenet_init_and_adam_steps_match_jax(digits):
    """init(123) as JAX's; then 3 Adam(1e-3) steps at batch 16 of
    digits, each loss within ATOL, and each param after them within
    1e-4 relative Frobenius (Adam moves a near-zero gradient by about
    lr whatever its rounding, so no elementwise tolerance holds)."""
    X, Y = digits
    jnet = jzoo.LeNet().init()
    net = zoo.LeNet().init(device="cpu")
    assert net.conf.to_dict() == jnet.conf.to_dict()
    got = to_jax_params(net)
    for k, lv in to_numpy_params(jnet.params).items():
        for n, a in lv.items():
            err = np.abs(got[k][n] - a).max() / max(np.abs(a).max(), 1e-30)
            assert err <= INIT_RTOL, (k, n, err)
    net = from_jax_params(net, to_numpy_params(jnet.params))
    for i in range(3):
        x, y = X[16 * i:16 * (i + 1)], Y[16 * i:16 * (i + 1)]
        jnet.fit(JaxDataSet(x, y), batch_size=16)
        net.fit(DataSet(x, y), batch_size=16)
        assert abs(net.score_value - jnet.score_value) <= ATOL
    got = to_jax_params(net)
    for k, lv in to_numpy_params(jnet.params).items():
        for n, a in lv.items():
            d = np.linalg.norm(got[k][n] - a) / np.linalg.norm(a)
            assert d <= 1e-4, (k, n, d)


def test_lenet_pretrained_mnist_matches_jax_on_held_out_digits(digits):
    """The packaged checkpoint restored by `init_pretrained(MNIST)` (its
    sha256 checked) and by JAX's ModelSerializer from the same file:
    output() of the 297 held-out digits within ATOL, accuracy 290/297 on
    both, as the manifest records."""
    X, Y = digits
    Xh, Yh = X[:chip_smoke.N_HELD_OUT], Y[:chip_smoke.N_HELD_OUT]
    net = zoo.LeNet().init_pretrained(zoo.PretrainedType.MNIST,
                                      device="cpu")
    jnet = JaxZip.restore_model(os.path.join(WEIGHTS_DIR, "lenet_mnist.zip"))
    got, want = net.output(Xh).numpy(), np.asarray(jnet.output(Xh))
    _close(got, want, what="output")
    acc = net.evaluate(DataSet(Xh, Yh)).accuracy()
    ev = JaxEvaluation(10)
    ev.eval(Yh, want)
    assert acc == ev.accuracy() == 290 / 297
    assert round(acc, 4) == 0.9764


@pytest.mark.parametrize("name", sorted(REDUCED))
def test_zoo_output_matches_jax(name):
    """output() at batch 2 of the port's `init(seed)` net and of the JAX
    net carrying its params (and running state), at REDUCED sizes; the
    embeddings of the face models have unit rows."""
    kw = REDUCED[name]
    model = getattr(zoo, name)(**kw)
    net = model.init(device="cpu")
    jcls = JaxNet if isinstance(net, MultiLayerNetwork) else JaxGraph
    jnet = _jax_twin(jcls(getattr(jzoo, name)(**kw).conf()), net)
    x, _ = chip_smoke.resnet_images(2, kw["height"], model.num_classes,
                                  seed=9)
    got, want = net.output(x).numpy(), np.asarray(jnet.output(x))
    assert got.shape == (2, model.num_classes)
    _close(got, want, what="output")
    if "embeddings" in getattr(net.conf, "nodes", {}):
        emb = net.feed_forward(x)["embeddings"]
        assert float((emb.norm(dim=-1) - 1).abs().max()) <= 1e-5


@pytest.mark.parametrize("name", ["SimpleCNN", "AlexNet"])
def test_zoo_fit_step_matches_jax(name):
    """One `fit` step (dropout on the dense layers from JAX's keys;
    SimpleCNN's BatchNorm in training) as JAX's: the loss, the params
    and the running state."""
    kw = REDUCED[name]
    model = getattr(zoo, name)(**kw)
    net = model.init(device="cpu")
    jnet = _jax_twin(JaxNet(getattr(jzoo, name)(**kw).conf()), net)
    x, y = chip_smoke.resnet_images(4, kw["height"], model.num_classes,
                                    seed=10)
    jnet.fit(JaxDataSet(x, y), batch_size=4)
    net.fit(DataSet(x, y), batch_size=4)
    np.testing.assert_allclose(net.score_value, jnet.score_value, rtol=ATOL)
    got = to_jax_params(net)
    for k, lv in to_numpy_params(jnet.params).items():
        for n, a in lv.items():
            d = np.linalg.norm(got[k][n] - a) / max(np.linalg.norm(a), 1e-30)
            assert d <= ATOL, (k, n, d)
    st = to_jax_state(net)
    for k, lv in to_numpy_params(jnet.net_state).items():
        for n, a in lv.items():
            _close(st[k][n], a, what=f"state {k}/{n}")


def test_vgg_imagenet_weights_are_refused_by_name():
    with pytest.raises(NotImplementedError, match="no weights"):
        zoo.VGG16().init_pretrained(zoo.PretrainedType.IMAGENET,
                                    device="cpu")
