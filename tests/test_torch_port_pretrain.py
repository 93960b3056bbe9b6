"""The port's unsupervised layers and layerwise pretraining against the JAX
package's, on the CPU: `prng.bernoulli` with a tensor p (RBM's per-unit
means) bit for bit; the `pretrain_loss` of AutoEncoder, RBM (CD-1 and
CD-2, every pair of unit kinds) and VariationalAutoencoder (each
reconstruction distribution, two samples) and their gradients;
`reconstruction_probability` and `generate_at_mean_given_z`; `pretrain()`
of both containers over two epochs against JAX's params; and which
updater `pretrain` runs (a layer's own, the builder's global one copied
into the layer, or Sgd(1e-3) when a layer has none).

Tolerances: ATOL = 1e-5 of the largest |value| of JAX's result. The
binary units sample ``uniform < mean``: the uniforms are JAX's bit for
bit and the means agree to rounding, so a sample can flip only where a
uniform sits within rounding of its mean; each RBM case counts the
flipped samples of its chain and expects none at these seeds.
"""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.common.updaters import Adam as JaxAdam
from deeplearning4j_tpu.common.updaters import Nesterovs as JaxNesterovs
from deeplearning4j_tpu.common.updaters import Sgd as JaxSgd
from deeplearning4j_tpu.nn.conf.builder import (
    NeuralNetConfiguration as JaxBuilder,
)
from deeplearning4j_tpu.nn.conf.graph import MergeVertex
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.graph import (
    ComputationGraphConfiguration as JaxGraphConf,
)
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.layers import rbm as jrbm
from deeplearning4j_tpu.nn.layers import variational as jvae
from deeplearning4j_tpu.nn.layers.base import layer_from_dict as jax_from_dict
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu_torch.common import prng
from deeplearning4j_tpu_torch.common.updaters import Sgd
from deeplearning4j_tpu_torch.nn.conf.builder import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph,
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers import AutoEncoder, layer_from_dict
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.jax_params import (
    from_jax_params,
    to_jax_params,
    to_numpy_params,
)

ATOL = 1e-5
N_IN, N_HID = 12, 7


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


def _unit(shape, seed):
    """Inputs in [0, 1], as the digits are."""
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


# ------------------------------------------------------------ bernoulli
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 7, 123456])
def test_bernoulli_with_tensor_p_is_jax_bit_for_bit(seed, dtype):
    p = _unit((9, 33), seed)
    jp = jnp.asarray(p).astype(dtype)
    want = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(seed), jp))
    got = prng.bernoulli(prng.key(seed), torch.from_numpy(p).to(
        getattr(torch, dtype)))
    assert got.dtype == torch.bool and got.shape == p.shape
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------- the layers' losses
def _loss_pair(jl, x, seed=3, key_seed=4):
    """JAX's and the port's `pretrain_loss` and its gradients in every
    param, from JAX's init, under one key: ((loss, grads), (loss,
    grads))."""
    pl = layer_from_dict(jl.to_dict())
    params = jl.init_params(jax.random.PRNGKey(seed))
    pl.load_jax_params({k: np.asarray(v) for k, v in params.items()})
    jkey = jax.random.PRNGKey(key_seed)
    loss, gp = jax.jit(jax.value_and_grad(
        lambda p: jl.pretrain_loss(p, jnp.asarray(x), jkey)))(params)
    pmap = pl.jax_param_map()
    for t in pmap.values():
        t.requires_grad_(True)
    got = pl.pretrain_loss(torch.from_numpy(x), prng.key(key_seed))
    got.backward()
    return ((float(got.detach()), {k: t.grad.numpy()
                                   for k, t in pmap.items()}),
            (float(loss), {k: np.asarray(v) for k, v in gp.items()}), pl,
            params, jkey)


def _check(got, want, what):
    _close(got[0], want[0], what=f"{what} loss")
    assert set(got[1]) == set(want[1])
    for k in want[1]:
        _close(got[1][k], want[1][k], what=f"{what} grad {k}")


@pytest.mark.parametrize("corruption", [0.0, 0.3])
def test_autoencoder_pretrain_loss_matches_jax(corruption):
    jl = jff.AutoEncoder(n_in=N_IN, n_out=N_HID, corruption_level=corruption)
    got, want, *_ = _loss_pair(jl, _unit((6, N_IN), 1))
    _check(got, want, "autoencoder")
    pl = layer_from_dict(jl.to_dict())
    params = jl.init_params(jax.random.PRNGKey(3))
    pl.load_jax_params({k: np.asarray(v) for k, v in params.items()})
    x = _unit((6, N_IN), 2)
    y0, _ = jl.forward(params, {}, jnp.asarray(x))
    _close(pl(torch.from_numpy(x)).numpy(), np.asarray(y0), what="encode")


def _jax_chain(jl, params, x, key):
    v = jnp.asarray(x)
    for step in range(jl.k):
        h = jl._sample_h(jax.random.fold_in(key, 2 * step), params, v)
        v = jl._sample_v(jax.random.fold_in(key, 2 * step + 1), params, h)
    return np.asarray(v)


@pytest.mark.parametrize("units", [("binary", "binary"),
                                   ("binary", "gaussian"),
                                   ("gaussian", "binary"),
                                   ("rectified", "binary"),
                                   ("rectified", "gaussian")])
@pytest.mark.parametrize("k", [1, 2])
def test_rbm_pretrain_loss_matches_jax(units, k):
    """CD-k's loss and gradients, the negative particle sampled as JAX
    samples it (no flipped sample at these seeds), the free energy and
    both propagations."""
    hidden, visible = units
    jl = jrbm.RBM(n_in=N_IN, n_out=N_HID, hidden_unit=hidden,
                  visible_unit=visible, k=k, sparsity=0.05)
    x = _unit((8, N_IN), 5)
    got, want, pl, params, jkey = _loss_pair(jl, x)
    chain = pl.gibbs_chain(torch.from_numpy(x), prng.key(4)).detach()
    jchain = _jax_chain(jl, params, x, jkey)
    if visible == "binary":
        assert int((chain.numpy() != jchain).sum()) == 0
    else:
        _close(chain.numpy(), jchain, what="chain")
    _check(got, want, f"rbm {units} k={k}")
    with torch.no_grad():
        xt = torch.from_numpy(x)
        _close(pl.free_energy(xt).numpy(),
               np.asarray(jl.free_energy(params, jnp.asarray(x))),
               what="free energy")
        _close(pl.prop_up(xt).numpy(),
               np.asarray(jl.prop_up(params, jnp.asarray(x))),
               what="prop_up")
        _close(pl(xt).numpy(),
               np.asarray(jl.forward(params, {}, jnp.asarray(x))[0]),
               what="forward")


RECON = {"gaussian": jvae.GaussianReconstructionDistribution("tanh"),
         "bernoulli": jvae.BernoulliReconstructionDistribution(),
         "exponential": jvae.ExponentialReconstructionDistribution()}


def _vae(recon, **kw):
    return jvae.VariationalAutoencoder(
        n_in=N_IN, n_out=3, encoder_layer_sizes=(9, 8),
        decoder_layer_sizes=(8,), reconstruction_distribution=RECON[recon],
        activation="leakyrelu", **kw)


@pytest.mark.parametrize("recon", sorted(RECON))
def test_vae_pretrain_loss_matches_jax(recon):
    """The negative ELBO and its gradients over two samples, the
    configuration's dict both ways, and the layer's forward (q(z|x)'s
    mean); `pzx_activation` on both heads."""
    jl = _vae(recon, num_samples=2, pzx_activation="tanh")
    x = _unit((6, N_IN), 6)
    got, want, pl, params, _ = _loss_pair(jl, x)
    _check(got, want, f"vae {recon}")
    assert pl.to_dict() == jl.to_dict()
    assert jax_from_dict(pl.to_dict()).to_dict() == jl.to_dict()
    y0, _ = jl.forward(params, {}, jnp.asarray(x))
    with torch.no_grad():
        _close(pl(torch.from_numpy(x)).numpy(), np.asarray(y0),
               what="forward")


@pytest.mark.parametrize("recon", sorted(RECON))
def test_vae_reconstruction_and_generation_match_jax(recon):
    jl = _vae(recon)
    pl = layer_from_dict(jl.to_dict())
    params = jl.init_params(jax.random.PRNGKey(8))
    pl.load_jax_params({k: np.asarray(v) for k, v in params.items()})
    x = _unit((5, N_IN), 9)
    want = jl.reconstruction_probability(params, jnp.asarray(x),
                                         jax.random.PRNGKey(10), 3)
    got = pl.reconstruction_probability(torch.from_numpy(x), prng.key(10), 3)
    _close(got.numpy(), np.asarray(want), what="log p(x)")
    z = np.random.default_rng(11).standard_normal((4, 3)).astype(np.float32)
    _close(pl.generate_at_mean_given_z(torch.from_numpy(z)).numpy(),
           np.asarray(jl.generate_at_mean_given_z(params, jnp.asarray(z))),
           what="generate")


# ------------------------------------------------------------- pretrain
def _stack_conf(global_updater, layer_updater=None):
    b = JaxBuilder.builder().seed(13)
    if global_updater is not None:
        b = b.updater(global_updater)
    return (b.list()
            .layer(jff.DenseLayer(n_out=10, activation="tanh"))
            .layer(jff.AutoEncoder(n_out=8, corruption_level=0.2,
                                   updater=layer_updater))
            .layer(jrbm.RBM(n_out=6))
            .layer(jvae.VariationalAutoencoder(
                n_out=2, encoder_layer_sizes=(5,), decoder_layer_sizes=(5,),
                reconstruction_distribution=(
                    jvae.BernoulliReconstructionDistribution())))
            .layer(jff.OutputLayer(n_out=3))
            .set_input_type(JaxInputType.feed_forward(N_IN)).build())


@pytest.mark.parametrize("updaters", ["global_sgd", "layer_adam",
                                      "global_nesterovs"])
def test_multilayer_pretrain_matches_jax(updaters):
    """Two epochs of `pretrain` over a dense layer (not pretrained, its
    output the features), an AutoEncoder, an RBM and a VAE: every param
    equals JAX's within ATOL. The updater is the layer's own where it has
    one (an Adam on the AutoEncoder beside a global Sgd), else the
    builder's global one copied into it (Sgd, Nesterovs)."""
    conf = {"global_sgd": lambda: _stack_conf(JaxSgd(0.1)),
            "layer_adam": lambda: _stack_conf(JaxSgd(0.1), JaxAdam(1e-2)),
            "global_nesterovs": lambda: _stack_conf(
                JaxNesterovs(0.05, 0.9))}[updaters]()
    jnet = JaxNet(conf).init(15)
    net = from_jax_params(MultiLayerNetwork(
        MultiLayerConfiguration.from_json(conf.to_json()), device="cpu"),
        to_numpy_params(jnet.params))
    x = _unit((20, N_IN), 16)
    jnet.pretrain(x, epochs=2, batch_size=8)
    net.pretrain(x, epochs=2, batch_size=8)
    assert len(net.pretrain_losses["1"]) == 6
    assert set(net.pretrain_losses) == {"1", "2", "3"}
    for key, lp in to_numpy_params(jnet.params).items():
        for name, a in lp.items():
            _close(to_jax_params(net)[key][name], a, what=f"{key} {name}")


def test_pretrain_without_any_updater_runs_sgd_1e_3():
    """A layer built without the builder has no updater: `pretrain` runs
    Sgd(1e-3), as JAX's `layer.updater or Sgd(1e-3)`."""
    layer = AutoEncoder(n_in=N_IN, n_out=5, corruption_level=0.0)
    net = MultiLayerNetwork([layer], device="cpu").init(17)
    ref = MultiLayerNetwork([layer.clone()], device="cpu")
    ref.load_state_dict(net.state_dict())
    ref.layers[0].updater = Sgd(1e-3)
    assert net.layers[0].updater is None
    x = _unit((8, N_IN), 18)
    net.pretrain(x, batch_size=8)
    ref.pretrain(x, batch_size=8)
    for name, t in net.layers[0].jax_param_map().items():
        assert torch.equal(t, ref.layers[0].jax_param_map()[name])


def _graph_conf():
    return (JaxGraphConf.graph_builder(JaxBuilder.builder().seed(19)
                                       .updater(JaxSgd(0.2)))
            .add_inputs("a")
            .set_input_types(JaxInputType.feed_forward(N_IN))
            .add_layer("dense", jff.DenseLayer(n_out=6, activation="relu"),
                       "a")
            .add_layer("ae", jff.AutoEncoder(n_out=5, corruption_level=0.3),
                       "dense")
            .add_layer("rbm", jrbm.RBM(n_out=3), "a")
            .add_vertex("merge", MergeVertex(), "ae", "rbm")
            .add_layer("out", jff.OutputLayer(n_out=2), "merge")
            .set_outputs("out").build())


def test_graph_pretrain_matches_jax():
    """`graph.pretrain` walks each pretrained node's ancestors only (the
    AutoEncoder over a dense node, the RBM on the input itself, merged
    below them): two epochs, every param equal to JAX's within ATOL."""
    conf = _graph_conf()
    jnet = JaxGraph(conf).init(21)
    net = from_jax_params(ComputationGraph(
        ComputationGraphConfiguration.from_json(conf.to_json()),
        device="cpu"), to_numpy_params(jnet.params))
    x = _unit((16, N_IN), 22)
    jnet.pretrain(x, epochs=2, batch_size=8)
    net.pretrain(x, epochs=2, batch_size=8)
    for key, lp in to_numpy_params(jnet.params).items():
        for name, a in lp.items():
            _close(to_jax_params(net)[key][name], a, what=f"{key} {name}")
