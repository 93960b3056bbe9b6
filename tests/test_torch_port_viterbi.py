"""The port's `util/` additions held against the JAX package's on the CPU:
the Viterbi decoder (`util/viterbi.py` over the scan kernel's plain
version, `kernels/viterbi.py`) and the disk-backed queue
(`util/diskqueue.py`).

- JAX's four `TestViterbi` cases (tests/test_util_streaming_depth.py) on
  the port, and seeded decodes whose path and score equal JAX's bit for
  bit: noisy metastable chains, T = 1, tables full of ties, -inf
  transitions and whole unreachable states.
- `viterbi_decode` with its default prior: the path equal to JAX's and
  the score within DEFAULT_PRIOR_ULPS float32 ulps (JAX computes -log(S)
  as a float32 log, one ulp off a correctly rounded one at S = 7, 47, 49
  and 179; the port rounds numpy's float64 log).
- JAX's `TestDiskBasedQueue` cases and its None-payload test.
"""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.util import viterbi as JV
from deeplearning4j_tpu_torch.kernels import viterbi as KV
from deeplearning4j_tpu_torch.util import (
    DiskBasedQueue,
    Viterbi,
    viterbi_decode,
)
from deeplearning4j_tpu_torch.util import viterbi as PV

CPU = "cpu"
DEFAULT_PRIOR_ULPS = 4


def noisy_chain(T, S, seed, stay=0.98, flip=0.01):
    """Observations of a seeded metastable chain: the hidden state stays
    with probability `stay`, else hops uniformly; each observation is
    replaced by a uniform draw with probability `flip`."""
    rng = np.random.default_rng(seed)
    hops = rng.random(T) >= stay
    targets = rng.integers(0, S, T)
    hidden = np.empty(T, np.int64)
    s = int(rng.integers(S))
    for t in range(T):
        if hops[t]:
            s = int(targets[t])
        hidden[t] = s
    noisy = rng.random(T) < flip
    return np.where(noisy, rng.integers(0, S, T), hidden)


def log_tables(T, S, seed, prior=True):
    """Seeded row-normalised log tables (float64 numpy)."""
    rng = np.random.default_rng(seed)

    def lsm(a):
        a = a - a.max(-1, keepdims=True)
        return a - np.log(np.exp(a).sum(-1, keepdims=True))
    em = lsm(rng.standard_normal((T, S)) * 2)
    tr = lsm(rng.standard_normal((S, S)))
    return em, tr, (lsm(rng.standard_normal(S)) if prior else None)


def jax_core(em, tr, pr):
    score, path = JV._viterbi_core(jnp.asarray(em), jnp.asarray(tr),
                                   jnp.asarray(pr))
    return np.float32(score), np.asarray(path)


def port_core(em, tr, pr):
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    score, path = KV.viterbi(f(em), f(tr), f(pr))
    assert score.dtype == torch.float32 and path.dtype == torch.int32
    return np.float32(score.item()), path.numpy()


def assert_bits(got, want):
    assert got[1].tolist() == want[1].tolist()
    assert np.array_equal(np.float32(got[0]).view(np.int32),
                          np.float32(want[0]).view(np.int32)), (got[0], want[0])


# ------------------------------------------- tests/test_util_streaming_depth
class TestViterbiCases:
    def test_smooths_isolated_flips(self):
        obs = np.array([0] * 10 + [1] * 10)
        obs[4] = 1
        obs[14] = 0
        v = Viterbi(num_states=2, p_correct=0.9, meta_stability=0.95,
                    device=CPU)
        score, path = v.decode(obs)
        assert path.tolist() == [0] * 10 + [1] * 10
        assert score < 0

    def test_binary_label_matrix_input(self):
        obs = np.eye(3)[[2, 2, 0, 2, 2]]
        v = Viterbi(num_states=3, p_correct=0.8, meta_stability=0.9,
                    device=CPU)
        _, path = v.decode(obs)
        assert path.tolist() == [2, 2, 2, 2, 2]

    def test_trusts_observations_when_emission_sharp(self):
        obs = np.array([0, 1, 0, 1, 0])
        v = Viterbi(num_states=2, p_correct=0.9999, meta_stability=0.6,
                    device=CPU)
        _, path = v.decode(obs)
        assert path.tolist() == obs.tolist()

    def test_general_hmm_decode(self):
        log_em = np.log(np.array([[0.9, 0.1], [0.02, 0.98], [0.9, 0.1]]))
        log_tr = np.log(np.array([[0.8, 0.2], [0.2, 0.8]]))
        _, path = viterbi_decode(log_em, log_tr, device=CPU)
        assert path.tolist() == [0, 1, 0]


# -------------------------------------------------------- parity with JAX
@pytest.mark.parametrize("S,T,p_correct,meta", [
    (2, 200, 0.9, 0.95), (5, 300, 0.99, 0.9), (77, 400, 0.99, 0.9),
    (77, 1, 0.99, 0.9), (13, 250, 1.0 / 13, 0.9)])
def test_decode_bit_equal_jax(S, T, p_correct, meta):
    """`Viterbi.decode`: path and score bit-equal to JAX's (p_correct =
    1/S makes every emission equal: ties at every step)."""
    obs = noisy_chain(T, S, seed=S * 1000 + T)
    want = JV.Viterbi(S, p_correct, meta).decode(obs)
    got = Viterbi(S, p_correct, meta, device=CPU).decode(obs)
    assert isinstance(got[0], float) and got[1].dtype == np.int32
    assert_bits(got, want)


@pytest.mark.parametrize("T,S", [(1, 7), (97, 3), (300, 33), (64, 130)])
def test_core_bit_equal_jax(T, S):
    em, tr, pr = log_tables(T, S, seed=T + S)
    assert_bits(port_core(em, tr, pr), jax_core(em, tr, pr))


def test_ties_and_unreachable_states_bit_equal_jax():
    """Integer-valued tables tie everywhere; -inf transitions (a banded
    chain) and a state no transition reaches take argmax's first index,
    as `jnp.argmax` does."""
    rng = np.random.default_rng(5)
    T, S = 200, 9
    em = -rng.integers(0, 3, (T, S)).astype(np.float64)
    tr = -rng.integers(0, 2, (S, S)).astype(np.float64)
    band = np.abs(np.arange(S)[:, None] - np.arange(S)[None, :]) > 1
    tr[band] = -np.inf
    tr[:, 4] = -np.inf                      # state 4 is never reached
    pr = np.zeros(S)
    pr[4] = -np.inf
    want = jax_core(em, tr, pr)
    assert_bits(port_core(em, tr, pr), want)
    assert 4 not in want[1].tolist()
    flat = (np.zeros((T, S)), np.zeros((S, S)), np.zeros(S))
    assert_bits(port_core(*flat), jax_core(*flat))
    assert port_core(*flat)[1].tolist() == [0] * T


@pytest.mark.parametrize("S", [7, 47, 49, 179, 64])
def test_default_prior_rounding(S):
    """The default prior: the path equal to JAX's; the score within
    DEFAULT_PRIOR_ULPS ulps (equal where both logs round alike)."""
    em, tr, _ = log_tables(120, S, seed=S)
    s_j, p_j = JV.viterbi_decode(em, tr)
    s_p, p_p = viterbi_decode(em, tr, device=CPU)
    assert p_p.tolist() == p_j.tolist()
    ulps = abs(int(np.float32(s_p).view(np.int32))
               - int(np.float32(s_j).view(np.int32)))
    assert ulps <= DEFAULT_PRIOR_ULPS
    jax_prior = np.float32(-jnp.log(S))
    if jax_prior == np.float32(-np.log(S)):
        assert ulps == 0
    # with JAX's own prior passed in, bit-equal
    s_e, p_e = viterbi_decode(em, tr, np.full(S, jax_prior), device=CPU)
    assert_bits((s_e, p_e), (s_j, p_j))


def test_plain_version_is_the_cpu_path_and_counts_no_launch():
    from deeplearning4j_tpu_torch import kernels as K
    em, tr, pr = log_tables(50, 6, seed=1)
    f = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    K.reset_launches()
    a = KV.viterbi(f(em), f(tr), f(pr))
    b = KV.viterbi_plain(f(em), f(tr), f(pr))
    assert K.LAUNCHES["viterbi"] == 0
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_wrapper_rejects_what_the_kernel_does_not_take():
    em, tr, pr = (torch.zeros(4, 3), torch.zeros(3, 3), torch.zeros(3))
    with pytest.raises(TypeError):
        KV.viterbi(em.double(), tr, pr)
    with pytest.raises(ValueError):
        KV.viterbi(em, torch.zeros(3, 4), pr)
    with pytest.raises(ValueError):
        KV.viterbi(torch.zeros(0, 3), tr, pr)
    with pytest.raises(ValueError):
        KV.viterbi(em, tr.to("meta"), pr)


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        Viterbi(3)
    with pytest.raises(RuntimeError, match="CUDA"):
        viterbi_decode(np.zeros((2, 3)), np.zeros((3, 3)))


def test_tables_are_float32_rounded_once():
    v = Viterbi(5, device=CPU)
    t = PV._table(v._log_trans, torch.device("cpu"))
    assert t.dtype == torch.float32
    assert np.array_equal(t.numpy(), np.asarray(jnp.asarray(v._log_trans)))


# ------------------------------------------------------------- disk queue
class TestDiskBasedQueue:
    def test_fifo_spill_and_restore(self):
        with DiskBasedQueue() as q:
            for i in range(5):
                q.add({"i": i, "arr": np.arange(i)})
            assert q.size() == 5
            assert q.peek()["i"] == 0
            out = [q.poll()["i"] for _ in range(5)]
            assert out == [0, 1, 2, 3, 4]
            assert q.poll() is None
            assert q.is_empty()

    def test_memory_window(self, tmp_path):
        q = DiskBasedQueue(str(tmp_path), memory_window=2)
        q.add_all([1, 2, 3, 4])
        assert len(os.listdir(tmp_path)) == 2   # only 3,4 spilled
        assert list(q) == [1, 2, 3, 4]

    def test_remove_raises_on_empty(self, tmp_path):
        q = DiskBasedQueue(str(tmp_path))
        with pytest.raises(IndexError):
            q.remove()

    def test_preserves_none_payload(self, tmp_path):
        q = DiskBasedQueue(str(tmp_path))
        q.add(1)
        q.add(None)
        q.add(2)
        assert list(q) == [1, None, 2]

    def test_close_removes_its_own_directory_only(self, tmp_path):
        own = DiskBasedQueue()
        own.add(1)
        d = own.dir
        own.close()
        assert not os.path.exists(d)
        given = DiskBasedQueue(str(tmp_path))
        given.add(2)
        given.close()
        assert os.path.isdir(tmp_path) and os.listdir(tmp_path) == []

    def test_each_package_reads_the_same_spill(self, tmp_path):
        """Both queues pickle one item a file: the port's spilled files
        are the JAX queue's format."""
        from deeplearning4j_tpu.util import DiskBasedQueue as JQ
        q = DiskBasedQueue(str(tmp_path))
        q.add_all([{"a": 1}, [2, 3]])
        j = JQ(str(tmp_path))
        j._paths.extend(q._paths)
        assert list(j) == [{"a": 1}, [2, 3]]
