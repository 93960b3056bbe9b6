"""The port's threefry (`deeplearning4j_tpu_torch/common/prng.py`) against
`jax.random` (JAX 0.9, `jax_threefry_partitionable=True`): keys, folds,
raw bits, uniform and bernoulli bit for bit; normal within rtol 1e-5
(XLA's float32 erfinv and torch's differ by about 5e-6 relative at the
tails; the uniform they start from is exact); bf16 uniform and normal
bit for bit. Then the dropout kernel's wrapper (`kernels/dropout.py`)
on the CPU, where it takes its plain version: the mask and the scaling
of `jax.random.bernoulli` dropout, the backward, and the device rule
(a CUDA tensor launches the kernel; there is no fallback).
"""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import kernels as K
from deeplearning4j_tpu_torch.common import prng
from deeplearning4j_tpu_torch.kernels import dropout as kd

SEEDS = [0, 1, 12346, 2 ** 31 - 1, -5]
SHAPES = [(7,), (3, 5, 11), (2, 1000)]


def jkey_tuple(k):
    return tuple(int(v) for v in np.asarray(k))


def key_pair(seed, fold):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), fold)
    return jk, prng.fold_in(prng.key(seed), fold)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_folds_match_jax(seed):
    jk, pk = jax.random.PRNGKey(seed), prng.key(seed)
    assert jkey_tuple(jk) == pk
    for d in (0, 1, 7, 0x5EED, 123456789, 2 ** 32 - 1):
        assert jkey_tuple(jax.random.fold_in(jk, d)) == prng.fold_in(pk, d)
    # chains: the container's step -> layer -> block -> weight-noise folds
    jc, pc = jk, pk
    for d in (3, 2, 1, 0x5EED):
        jc, pc = jax.random.fold_in(jc, d), prng.fold_in(pc, d)
        assert jkey_tuple(jc) == pc


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [1, 124])
def test_bits_uniform_bernoulli_are_bit_equal(seed, shape):
    jk, pk = key_pair(seed, 3)
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(jk, shape)).astype(np.int64),
        prng.bits(pk, shape).numpy())
    np.testing.assert_array_equal(np.asarray(jax.random.uniform(jk, shape)),
                                  prng.uniform(pk, shape).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(jk, shape, minval=-0.5, maxval=2.0)),
        prng.uniform(pk, shape, minval=-0.5, maxval=2.0).numpy())
    for p in (0.9, 0.5, 0.95, 0.1):
        np.testing.assert_array_equal(
            np.asarray(jax.random.bernoulli(jk, p, shape)),
            prng.bernoulli(pk, p, shape).numpy())


@pytest.mark.parametrize("shape", SHAPES)
def test_normal_matches_jax(shape):
    jk, pk = key_pair(7, 11)
    np.testing.assert_allclose(prng.normal(pk, shape).numpy(),
                               np.asarray(jax.random.normal(jk, shape)),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_uniform_and_normal_are_bit_equal(shape):
    jk, pk = key_pair(9, 2)
    for jfn, pfn in (
            (lambda: jax.random.uniform(jk, shape, jnp.bfloat16),
             lambda: prng.uniform(pk, shape, torch.bfloat16)),
            (lambda: jax.random.normal(jk, shape, jnp.bfloat16),
             lambda: prng.normal(pk, shape, torch.bfloat16))):
        np.testing.assert_array_equal(
            np.asarray(jfn()).astype(np.float32), pfn().float().numpy())


def test_bits_of_an_index_range_are_the_tail_of_the_whole():
    pk = prng.fold_in(prng.key(3), 1)
    whole = kd.threefry_bits(pk, 1000, "cpu")
    np.testing.assert_array_equal(kd.threefry_bits(pk, 300, "cpu", 700),
                                  whole[700:])
    # an offset past 2^32 feeds the high word (JAX's iota_2x32_shape)
    hi = kd.threefry_bits_plain(pk, 4, "cpu", 2 ** 32 - 2)
    want = [prng.threefry2x32(pk[0], pk[1], n >> 32, n & prng.MASK)
            for n in range(2 ** 32 - 2, 2 ** 32 + 2)]
    assert hi.tolist() == [a ^ b for a, b in want]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [0.9, 0.5])
def test_dropout_matches_jax_where_bernoulli(dtype, p):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    x = np.random.default_rng(0).standard_normal((4, 33, 16)).astype(
        np.float32)
    jk, pk = key_pair(5, 2)
    jx = jnp.asarray(x, jdt)
    want = jnp.where(jax.random.bernoulli(jk, p, x.shape),
                     jx / jnp.asarray(p, jdt), jnp.zeros_like(jx))
    got = kd.dropout(torch.from_numpy(x).to(dtype), pk, p)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want).astype(np.float32))
    assert K.LAUNCHES["dropout"] == 0          # the plain version ran


def test_dropout_backward_is_the_masked_gradient_over_p():
    x = torch.randn(3, 50, dtype=torch.float64).float().requires_grad_(True)
    pk = prng.fold_in(prng.key(1), 9)
    y = kd.dropout(x, pk, 0.8)
    g = torch.randn(3, 50)
    y.backward(g)
    keep = prng.bernoulli(pk, 0.8, x.shape)
    want = torch.where(keep, g / torch.tensor(0.8), torch.zeros(()))
    assert torch.equal(x.grad, want)
    # jax.vjp of the same function gives the same gradient
    jk = jax.random.fold_in(jax.random.PRNGKey(1), 9)

    def f(a):
        return jnp.where(jax.random.bernoulli(jk, 0.8, a.shape),
                         a / jnp.asarray(0.8, a.dtype), jnp.zeros_like(a))
    _, vjp = jax.vjp(f, jnp.asarray(x.detach().numpy()))
    np.testing.assert_array_equal(x.grad.numpy(),
                                  np.asarray(vjp(jnp.asarray(g.numpy()))[0]))


def test_dropout_retain_one_is_identity_and_views_take_their_own_index():
    x = torch.randn(6, 10)
    pk = prng.key(0)
    assert kd.dropout(x, pk, 1.0) is x
    view = x[:, 2:7]
    assert torch.equal(kd.dropout(view, pk, 0.5),
                       kd.dropout(view.contiguous(), pk, 0.5))


@pytest.mark.parametrize("n,offset", [(2 * kd.CPU_CHUNK + 5, 0),
                                      (kd.CPU_CHUNK + 3, 2 ** 32 - 1000)])
def test_plain_words_in_passes_equal_one_pass(n, offset):
    """The CPU's plain words run in passes of CPU_CHUNK words: the same
    words as one pass over the whole range, across pass and 32-bit word
    boundaries."""
    pk = prng.fold_in(prng.key(9), 4)
    idx = torch.arange(offset, offset + n, dtype=torch.int64)
    y0, y1 = prng.threefry2x32(pk[0], pk[1], idx >> 32, idx & prng.MASK)
    assert torch.equal(kd.threefry_bits_plain(pk, n, "cpu", offset), y0 ^ y1)
    assert kd.threefry_bits_plain(pk, 0, "cpu").shape == (0,)


@pytest.mark.parametrize("base", [0, 2 ** 31 - 8, 2 ** 32 - 8,
                                  2 ** 33 + 2 ** 31 - 8])
def test_int32_threefry_equals_the_generic_form(base):
    """Tensor words under an int key hash in int32 (wrapping adds, masked
    right shifts); the generic form (tensor keys, int64 with a 32-bit
    mask) and the Python-int form are the reference, across the signed
    and the 32-bit word boundaries."""
    idx = torch.arange(base, base + 16, dtype=torch.int64)
    for k0, k1 in ((0, 123), (0xFFFFFFFF, 0x80000001), (2 ** 31, 2 ** 31 - 1)):
        got = prng.threefry2x32(k0, k1, idx >> 32, idx & prng.MASK)
        want = prng.threefry2x32(torch.tensor(k0), torch.tensor(k1),
                                 idx >> 32, idx & prng.MASK)
        assert got[0].dtype == torch.int64
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        i = int(idx[5])
        assert prng.threefry2x32(k0, k1, i >> 32, i & prng.MASK) == (
            int(got[0][5]), int(got[1][5]))


def test_cuda_tensors_go_to_the_kernel_or_raise():
    """The wrappers decide by device: a CUDA device builds and launches
    the kernel (without CUDA it raises); another device is refused.
    Nothing falls back to the plain version."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py holds the kernel")
    with pytest.raises((RuntimeError, AssertionError)):
        kd.threefry_bits(prng.key(0), 8, "cuda")
    with pytest.raises(ValueError):
        kd.threefry_bits(prng.key(0), 8, "meta")


# --------------------------------------------------- on the card (skip here)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_dropout_and_bits_kernels_are_bit_equal_to_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pk = prng.fold_in(prng.key(7), 2)
    x = torch.randn(4, 333, 65).to("cuda", dtype)
    for p in (0.9, 0.5):
        assert torch.equal(kd.dropout_fwd(x, pk, p),
                           kd.dropout_plain(x, pk, p))
    for offset in (0, 2 ** 32 - 10):
        assert torch.equal(kd.threefry_bits(pk, 1000, "cuda", offset),
                           kd.threefry_bits_plain(pk, 1000, "cuda", offset))
