"""The port's t-SNE (`deeplearning4j_tpu_torch/plot/tsne.py`) held against
the JAX package's on the CPU, at tests/test_clustering.py's exact-run
size (120 points, perplexity 15, 250 steps).

- P (`_compute_p`, the host float64 binary search) bit-equal to JAX's.
- Every step of the run from JAX's own state (y, velocity, gains) within
  STEP_RTOL of max|y| of JAX's next state, the gains that flip counted
  (measured: 1.1e-5 at worst, one flip in 250 steps).
- The free run within STEP_RTOL for its first EXACT_STEPS steps. Past
  them it leaves JAX's, as JAX's own run leaves a twin whose y0 moved by
  one float32 ulp (measured: the twin 5.6e-4 of max|y| away after 10
  steps, order 1 after 15): the map is chaotic there. So the whole run
  is held by the noisy-twin rule (ROADMAP Hazards, ill-conditioned
  parity): its KL within 1 % of JAX's, or within TWIN_FACTOR x the
  farther of JAX's two one-ulp twins; and the test's separation check.
- Barnes-Hut above 512 points is the JAX package's host numpy algorithm
  unchanged: bit-equal at 513 points over 2 iterations.
"""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.plot import tsne as JT
from deeplearning4j_tpu_torch.plot import BarnesHutTsne, Tsne
from deeplearning4j_tpu_torch.plot import tsne as PT

CPU = "cpu"
STEP_RTOL = 1e-4
EXACT_STEPS = 5
TWIN_FACTOR = 2.0
MAX_FLIPS = 3
RUN = dict(perplexity=15.0, n_iter=250, seed=0)


def clustered(n=60, d=10):
    rng = np.random.default_rng(6)
    return np.concatenate([rng.standard_normal((n, d)) * 0.3 + 4,
                           rng.standard_normal((n, d)) * 0.3 - 4])


def _j(a):
    """A fresh JAX array from a copy (`_tsne_step` donates its inputs)."""
    return jnp.asarray(np.array(a))


def jax_run(p, y0, n_iter=250, momentum=0.5, final_momentum=0.8,
            exaggeration=12.0, lr=200.0):
    """JAX's `Tsne.fit_transform` loop from a given y0: the maps after
    every step and the last KL."""
    y, v, g = _j(y0), jnp.zeros(y0.shape, jnp.float32), jnp.ones(
        y0.shape, jnp.float32)
    p_dev = jnp.asarray(p)
    exag_end = min(100, n_iter // 4)
    ys, gs = [], []
    for it in range(n_iter):
        mom = momentum if it < 250 else final_momentum
        y, v, g, kl = JT._tsne_step(
            p_dev * exaggeration if it < exag_end else p_dev, y, v, g,
            np.float32(mom), np.float32(lr))
        ys.append(np.array(y))
        gs.append(np.array(g))
    return ys, gs, float(kl)


@pytest.fixture(scope="module")
def run():
    """P, y0 (float32), the JAX run and the port's free run."""
    x = clustered()
    t = Tsne(**RUN, device=CPU)
    p = t.input_affinities(x)
    y0 = t.initial_map(len(x)).astype(np.float32)
    ys, gs, kl = jax_run(p, y0)
    return dict(x=x, tsne=t, p=p, y0=y0, jax_ys=ys, jax_gs=gs, jax_kl=kl)


def test_affinities_bit_equal_jax():
    for n, d, perp, seed in ((120, 10, 15.0, 6), (77, 4, 30.0, 1),
                             (300, 8, 5.0, 2)):
        x = np.random.default_rng(seed).standard_normal((n, d))
        assert np.array_equal(PT._compute_p(x, perp), JT._compute_p(x, perp))
        row = np.abs(x[0]) * 3
        assert np.array_equal(PT._binary_search_perplexity(row, perp),
                              JT._binary_search_perplexity(row, perp))
    x = clustered()
    perp = min(15.0, max((len(x) - 1) / 3.0, 1.0))
    assert np.array_equal(Tsne(**RUN, device=CPU).input_affinities(x),
                          JT._compute_p(x, perp))


def test_jax_run_helper_is_jax_fit_transform(run):
    """The twins below run JAX's own loop: from JAX's y0 it reproduces
    `Tsne.fit_transform` bit for bit."""
    j = JT.Tsne(**RUN)
    y = j.fit_transform(run["x"])
    assert np.array_equal(y, run["jax_ys"][-1])
    assert j.kl_divergence_ == run["jax_kl"]


def test_each_step_from_jax_state(run):
    """Teacher-forced: the port's step from JAX's state at every step of
    the run, against JAX's next state."""
    p = run["p"]
    pt = torch.from_numpy(p).float()
    pts = (pt * 12.0, pt)
    y, v, g = _j(run["y0"]), jnp.zeros((120, 2)), jnp.ones((120, 2))
    worst, flips = 0.0, 0
    for it in range(250):
        yt, vt, gt = (torch.from_numpy(np.array(a)) for a in (y, v, g))
        kl_p = PT._tsne_step(pts[0 if it < 62 else 1], yt, vt, gt, 0.5,
                             200.0)
        y, v, g, kl = JT._tsne_step(_j(p) * 12.0 if it < 62 else _j(p), y,
                                    v, g, np.float32(0.5), np.float32(200.0))
        yn = np.asarray(y)
        worst = max(worst, float(np.abs(yt.numpy() - yn).max()
                                 / np.abs(yn).max()))
        flips += int((gt.numpy() != np.asarray(g)).sum())
        assert float(kl_p) == pytest.approx(float(kl), rel=1e-5)
    assert worst <= STEP_RTOL
    assert flips <= MAX_FLIPS


def test_free_run_first_steps(run):
    t = run["tsne"]
    for n in (1, EXACT_STEPS):
        y, _, _ = t.descend(run["p"], run["y0"], n)
        want = run["jax_ys"][n - 1]
        assert y.dtype == np.float32
        assert np.abs(y - want).max() <= STEP_RTOL * np.abs(want).max()


def test_whole_run_by_the_noisy_twin_rule(run):
    t = Tsne(**RUN, device=CPU)
    y = t.fit_transform(run["x"])
    assert y.shape == (120, 2) and y.dtype == np.float32
    # the test's separation check
    ca, cb = y[:60].mean(0), y[60:].mean(0)
    assert np.linalg.norm(ca - cb) > 2 * max(y[:60].std(), y[60:].std())
    kl_j = run["jax_kl"]
    off = abs(t.kl_divergence_ - kl_j)
    if off > 0.01 * kl_j:
        twins = [jax_run(run["p"], np.nextafter(run["y0"], np.float32(s)))[2]
                 for s in (np.inf, -np.inf)]
        assert off <= TWIN_FACTOR * max(abs(k - kl_j) for k in twins), (
            t.kl_divergence_, kl_j, twins)


def test_descend_keeps_its_inputs():
    p = PT._compute_p(clustered(10, 3), 5.0)
    y0 = Tsne(device=CPU).initial_map(20).astype(np.float32)
    keep = y0.copy()
    _, kl, kls = Tsne(device=CPU).descend(p, y0, 3, kl_steps=(0, 2))
    assert np.array_equal(y0, keep)
    assert sorted(kls) == [0, 2] and kls[2] == kl


def test_barnes_hut_large_bit_equal_jax():
    rng = np.random.default_rng(7)
    x = np.concatenate([rng.standard_normal((257, 5)) + 3,
                        rng.standard_normal((256, 5)) - 3])
    got = BarnesHutTsne(theta=0.8, n_iter=2, seed=0, device=CPU).fit_transform(x)
    want = JT.BarnesHutTsne(theta=0.8, n_iter=2, seed=0).fit_transform(x)
    assert np.array_equal(got, want)


def test_barnes_hut_small_takes_the_exact_path():
    x = clustered(20, 4)
    got = BarnesHutTsne(theta=0.5, n_iter=30, seed=1,
                        device=CPU).fit_transform(x)
    want = Tsne(n_iter=30, seed=1, device=CPU).fit_transform(x)
    assert np.array_equal(got, want)


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        Tsne()
    with pytest.raises(RuntimeError, match="CUDA"):
        BarnesHutTsne()
