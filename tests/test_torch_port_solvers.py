"""The port's line-search solvers (`optimize/solvers.py`) against the JAX
package's, on the CPU: each solver with each step function, score by
score through `Solver.optimize` on a tiny MLP; `BackTrackLineSearch` on
a quadratic; the flat order of the params (`ravel_pytree`'s, layer "10"
before "2"); and `fit` under a line-search `optimization_algo` on both
containers.

Tolerances: iteration 0's score within 1e-6 relative (the same params
and data; the two packages' fp32 sums differ in their last bits), the
later scores and the final params within 1e-4 relative (the line
search's Armijo test branches on those floats).
"""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.common.updaters import Sgd as JaxSgd
from deeplearning4j_tpu.nn.conf import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxBuilder
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.graph import (
    ComputationGraphConfiguration as JaxGraphConf,
)
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.optimize import solvers as js
from deeplearning4j_tpu_torch.nn.conf.builder import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph,
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import solvers as ps
from deeplearning4j_tpu_torch.util.jax_params import (
    from_jax_params,
    to_jax_params,
    to_numpy_params,
)

FIRST_RTOL = 1e-6
LATER_RTOL = 1e-4
ALGOS = ["line_gradient_descent", "conjugate_gradient", "lbfgs"]
STEPS = ["default", "negative_default", "gradient", "negative_gradient"]


def mlp_conf(algo="sgd", max_iter=5, depth=2):
    b = (JaxBuilder.builder().seed(5).updater(JaxSgd(0.1))
         .optimization_algo(algo).max_iterations(max_iter).list())
    b = b.layer(jl.DenseLayer(n_in=6, n_out=8, activation="tanh"))
    for _ in range(depth - 1):
        b = b.layer(jl.DenseLayer(n_in=8, n_out=8, activation="tanh"))
    return (b.layer(jl.OutputLayer(n_in=8, n_out=3, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(JaxInputType.feed_forward(6)).build())


def port_of(jconf):
    return MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()


def data(n=24, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


def assert_params_close(net, jparams, rtol=LATER_RTOL):
    got = to_jax_params(net)
    for lk, lp in to_numpy_params(jparams).items():
        for name, w in lp.items():
            scale = max(1.0, float(np.abs(w).max()))
            assert float(np.abs(got[lk][name] - w).max()) <= rtol * scale


def assert_scores_close(got, want):
    assert len(got) == len(want), (got, want)
    np.testing.assert_allclose(got[0], want[0], rtol=FIRST_RTOL)
    np.testing.assert_allclose(got, want, rtol=LATER_RTOL)


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("algo", ALGOS)
def test_solver_matches_jax_per_iteration(algo, step):
    x, y = data()
    conf = mlp_conf()
    jnet, net = JaxNet(conf).init(), port_of(conf)
    jls = js.BackTrackLineSearch(step_function=js.step_function_from_dict(
        step))
    pls = ps.BackTrackLineSearch(step_function=ps.step_function_from_dict(
        step))
    jsol = js.Solver(jnet, algo, max_iterations=4, line_search=jls)
    psol = ps.Solver(net, algo, max_iterations=4, line_search=pls,
                     device="cpu")
    jscore = jsol.optimize(x, y)
    pscore = psol.optimize(net._features(x), net._labels(y))
    assert_scores_close(psol.scores, jsol.scores)
    np.testing.assert_allclose(pscore, jscore, rtol=LATER_RTOL)
    assert_params_close(net, jnet.params)
    if step in ("default", "gradient"):
        assert psol.scores[-1] < psol.scores[0]     # the loss falls
    else:
        assert psol.scores == psol.scores[:1]       # not a descent step


def test_backtrack_line_search_on_a_quadratic():
    rng = np.random.default_rng(3)
    m = rng.standard_normal((5, 5))
    a = (m @ m.T + 5 * np.eye(5)).astype(np.float32)
    x0 = rng.standard_normal(5).astype(np.float32)

    def f_np(x):
        return 0.5 * x @ a @ x

    at = torch.as_tensor(a)
    xt = torch.as_tensor(x0)
    g = at @ xt
    got = ps.BackTrackLineSearch().optimize(
        lambda v: float(0.5 * v @ at @ v), xt, float(f_np(x0)), g, -g)
    ja = jnp.asarray(a)
    jx = jnp.asarray(x0)
    want = js.BackTrackLineSearch().optimize(
        lambda v: 0.5 * v @ ja @ v, jx, float(f_np(x0)), ja @ jx, -(ja @ jx))
    assert got[0] == want[0] and 0 < got[0] <= 1.0
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    slope = -float(g @ g)
    assert got[1] <= f_np(x0) + 1e-4 * got[0] * slope
    assert ps.BackTrackLineSearch().optimize(
        lambda v: 0.0, xt, 1.0, g, g) == (0.0, 1.0)


def test_flat_order_is_ravel_pytrees():
    """Layer keys sort as strings (layer "10" before "2"), then the
    param names; the flat vector is JAX's `ravel_pytree` of the
    params."""
    conf = mlp_conf(depth=11)
    jnet, net = JaxNet(conf).init(), port_of(conf)
    from_jax_params(net, to_numpy_params(jnet.params))
    order = [lk for lk, _, _ in ps.flat_order(net)]
    assert order.index("10") < order.index("2")
    flat = torch.cat([p.reshape(-1) for _, _, p in ps.flat_order(net)])
    want, _ = jax.flatten_util.ravel_pytree(jnet.params)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(want))


@pytest.mark.parametrize("algo", ALGOS)
def test_fit_with_a_line_search_algo_matches_jax(algo):
    """`fit` runs one `Solver.optimize` a minibatch for max_iterations
    (3), the score is the solver's, the iteration count moves by one a
    minibatch."""
    x, y = data(n=16)
    conf = mlp_conf(algo, max_iter=3)
    jnet, net = JaxNet(conf).init(), port_of(conf)
    for i in (0, 8):
        jnet.fit(x[i:i + 8], y[i:i + 8], batch_size=8, shuffle=False)
        net.fit(x[i:i + 8], y[i:i + 8], batch_size=8, shuffle=False)
        np.testing.assert_allclose(net.score_value, jnet.score_value,
                                   rtol=LATER_RTOL)
    assert net.iteration_count == jnet.iteration_count == 2
    assert_params_close(net, jnet.params)


def test_graph_fit_with_lbfgs_matches_jax():
    g = JaxGraphConf.graph_builder(
        JaxBuilder.builder().seed(2).updater(JaxSgd(0.1))
        .optimization_algo("lbfgs").max_iterations(3))
    g.add_inputs("in")
    g.add_layer("d", jl.DenseLayer(n_in=6, n_out=8, activation="tanh"), "in")
    g.add_layer("out", jl.OutputLayer(n_in=8, n_out=3, activation="softmax",
                                      loss="mcxent"), "d")
    g.set_outputs("out")
    conf = g.build()
    x, y = data(n=8)
    jnet = JaxGraph(conf).init()
    net = ComputationGraph(ComputationGraphConfiguration.from_json(
        conf.to_json()), device="cpu").init()
    jnet.fit(x, y, batch_size=8)
    net.fit(x, y, batch_size=8)
    np.testing.assert_allclose(net.score_value, jnet.score_value,
                               rtol=LATER_RTOL)
    assert_params_close(net, jnet.params)


def test_solver_refusals():
    net = port_of(mlp_conf())
    with pytest.raises(ValueError):
        ps.Solver(net, "sgd", device="cpu")
    with pytest.raises(ValueError):
        ps.Solver(net, "lbfgs", device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ps.Solver(net, "lbfgs")
