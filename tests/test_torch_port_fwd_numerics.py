"""The rounding of the tensor-core flash forward, emulated on the CPU
(`deeplearning4j_tpu_torch/kernels/csrc/flash_attention.cu`, finalize
and carry modes).

The CUDA kernel runs only on the card; what it does to the numbers can
be replayed here in plain torch, tile by tile as the kernel walks the
keys (64-key tiles): S = Q·Kᵀ with its operands rounded as the tensor
cores see them, scaled to log2 units, the online softmax in fp32, and
each tile's P·V summed from zero and added in fp32 to acc · corr
(exact products summed in float64 stand in for the tensor cores' sums).
The operand rounding:
- fp32 inputs, 3xTF32: x = hi + lo, both rounded to TF32 (cvt.rna), and
  a·b = lo·hi + hi·lo + hi·hi; 1xTF32 (what the kernel does not do):
  hi·hi only;
- bf16 inputs: S from the inputs as they are; P rounded to bf16 before
  P·V in finalize mode, and split into bf16 hi + lo in carry mode.
The emulations are held against the JAX package's forward and carry
fold (the Pallas kernel in interpret mode with 64-row tiles) at the
port's fp32 tolerances (o 2e-5, lse 1e-4, the carry state 2e-5 of each
tensor's own scale), against an fp64 reference for why three passes
are needed, and against the port's plain versions at the bf16 bounds
that `chip_smoke.py` holds the kernel to on the card. The bf16 carry
shows why P is split: a single bf16 P misses the carry bound.

What this does not emulate is the tensor cores' own fp32 accumulation,
which rounds toward zero inside a tile; `chip_smoke.py` phase 2 reads
the kernel's error on the card.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.kernels.flash_attention import (
    _flash_forward,
    flash_attention_carry as jax_carry,
)
from deeplearning4j_tpu_torch.kernels.flash_attention import (
    NEG_INF,
    _kernel_layout,
    _scale,
    flash_attention_carry_plain,
    flash_attention_plain,
)
from deeplearning4j_tpu_torch.nn.layers import MultiHeadAttention
from deeplearning4j_tpu_torch.parallel.mesh import shard

O_ATOL, LSE_ATOL = 2e-5, 1e-4    # the port's fp32 forward tolerances
CARRY_RTOL = 2e-5                 # of each state tensor's own scale
BF16_O_ATOL = 2 ** -5             # chip_smoke's FLASH_TOL["bfloat16"]
BN = 64                           # the kernel's key tile at D 32 and 64
T = 100                           # two key tiles, the second ragged
LOG2E = np.float32(np.log2(np.e))
CASES = [(causal, D) for causal in (True, False) for D in (32, 64)]


def _inputs(D, seed=90, dtype=torch.float32):
    """q, k, v [1, T, 2, D] from a numpy seed, in `dtype`."""
    rng = np.random.default_rng(seed + D)
    return [torch.from_numpy(rng.standard_normal((1, T, 2, D)).astype(
        np.float32)).to(dtype) for _ in range(3)]


def _state(D, seed=91):
    """A seeded carry state (m, l [1, 2, T], acc [1, 2, T, D]), as
    chip_smoke seeds its visible folds."""
    rng = np.random.default_rng(seed + D)
    m = rng.standard_normal((1, 2, T)) + 2.0
    l = np.abs(rng.standard_normal((1, 2, T))) + 1.0
    acc = rng.standard_normal((1, 2, T, D))
    return [torch.from_numpy(a.astype(np.float32)) for a in (m, l, acc)]


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits), ties away from zero: the
    kernel's cvt.rna.tf32.f32."""
    b = x.float().contiguous().view(torch.int32)
    mag = ((b & 0x7FFFFFFF) + 0x1000) & -0x2000
    return (mag | (b & -0x80000000)).view(torch.float32)


def _mm_3xtf32(a, b):
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return (a_lo.double() @ b_hi.double() + a_hi.double() @ b_lo.double()
            + a_hi.double() @ b_hi.double()).float()


def _mm_1xtf32(a, b):
    return (_tf32(a).double() @ _tf32(b).double()).float()


def _mm_exact(a, b):
    # operands already bf16 values (or split into such): exact products
    return (a.double() @ b.double()).float()


def _p_bf16(p):
    return p.bfloat16().float()


def _p_split(p):
    hi = p.bfloat16().float()
    return hi.double() + (p - hi).bfloat16().double()


# mode: (S product, P as the second product's A operand, P·V product)
MODES = {
    "3xtf32": (_mm_3xtf32, None, _mm_3xtf32),
    "1xtf32": (_mm_1xtf32, None, _mm_1xtf32),
    "bf16": (_mm_exact, _p_bf16, _mm_exact),
    "bf16_split": (_mm_exact, _p_split, _mm_exact),
}


def _emulate(q, k, v, mode, causal, state=None):
    """The kernel's fold of k, v into the online-softmax state, tile by
    tile. Without `state`: (o [B, Tq, H, D] fp32, lse [B, H, Tq]), as in
    finalize mode; with `state` (m, l, acc): the folded (m, l, acc)."""
    mm_s, round_p, mm_pv = MODES[mode]
    Q, K, V = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))
    Tq, Tk, D = Q.shape[2], K.shape[2], Q.shape[3]
    sl2 = np.float32(_scale(D)) * LOG2E
    if state is None:
        m2 = torch.full(Q.shape[:3], NEG_INF)
        l, acc = torch.zeros(Q.shape[:3]), torch.zeros(Q.shape)
    else:
        m2, l, acc = state[0] * LOG2E, state[1].clone(), state[2].clone()
    qpos = torch.arange(Tq)[:, None]
    for k0 in range(0, Tk, BN):
        Kt, Vt = K[:, :, k0:k0 + BN], V[:, :, k0:k0 + BN]
        x = mm_s(Q, Kt.transpose(-1, -2)) * sl2
        kpos = torch.arange(k0, k0 + Kt.shape[2])[None, :]
        if causal:
            x = torch.where(kpos <= qpos, x, torch.full_like(x, NEG_INF))
        m_new = torch.maximum(m2, x.max(-1).values)
        corr = torch.exp2(m2 - m_new)
        p = torch.exp2(x - m_new[..., None])
        l = l * corr + p.sum(-1)
        part = mm_pv(round_p(p) if round_p else p, Vt)
        acc = acc * corr[..., None] + part
        m2 = m_new
    if state is not None:
        return m2 / LOG2E, l, acc
    ls = l.clamp_min(1e-20)
    return (acc / ls[..., None]).permute(0, 2, 1, 3), m2 / LOG2E + ls.log()


def _reference64(q, k, v, causal):
    """o of plain attention in float64."""
    Q, K, V = (t.double().permute(0, 2, 1, 3) for t in (q, k, v))
    s = Q @ K.transpose(-1, -2) / np.sqrt(Q.shape[-1])
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return (torch.softmax(s, -1) @ V).permute(0, 2, 1, 3)


@functools.lru_cache(maxsize=None)
def _jax_forward(causal, D):
    """(o, lse) of the JAX forward, Pallas in interpret mode, 64-row
    tiles; under jit, where the interpreted kernel traces once."""
    fwd = jax.jit(lambda q, k, v: _flash_forward(
        q, k, v, block_q=64, block_k=64, causal=causal, interpret=True))
    return [np.array(a) for a in fwd(*(jnp.asarray(t.numpy())
                                         for t in _inputs(D)))]


@functools.lru_cache(maxsize=None)
def _jax_fold(diag, D):
    """The JAX carry fold of k, v into the seeded state (interpret)."""
    fold = jax.jit(lambda *a: jax_carry(*a, diag=diag, block_q=64,
                                        block_k=64, interpret=True))
    args = [jnp.asarray(t.numpy()) for t in _inputs(D) + _state(D)]
    return [np.array(a) for a in fold(*args)]


def _carry_errs(got, want):
    """Each state tensor's max |difference| over max(1, its max |want|)."""
    return [float((torch.as_tensor(a).double() - torch.as_tensor(b).double())
                  .abs().max()) / max(1.0, float(np.abs(np.asarray(b)).max()))
            for a, b in zip(got, want)]


@pytest.mark.parametrize("causal,D", CASES)
def test_3xtf32_forward_matches_jax(causal, D):
    o, lse = _emulate(*_inputs(D), "3xtf32", causal)
    o_want, lse_want = _jax_forward(causal, D)
    np.testing.assert_allclose(o.numpy(), o_want, atol=O_ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), lse_want, atol=LSE_ATOL, rtol=0)


@pytest.mark.parametrize("diag,D", CASES)
def test_3xtf32_carry_matches_jax(diag, D):
    got = _emulate(*_inputs(D), "3xtf32", diag, state=_state(D))
    assert max(_carry_errs(got, _jax_fold(diag, D))) <= CARRY_RTOL


@pytest.mark.parametrize("causal,D", CASES)
def test_1xtf32_is_ten_times_further_off_than_3xtf32(causal, D):
    """Plain TF32 products would miss the fp32 tolerance; the split
    brings the error back to fp32's. Against fp64."""
    q, k, v = _inputs(D)
    want = _reference64(q, k, v, causal)
    err3 = float((_emulate(q, k, v, "3xtf32", causal)[0].double()
                  - want).abs().max())
    err1 = float((_emulate(q, k, v, "1xtf32", causal)[0].double()
                  - want).abs().max())
    assert err3 < 2e-6
    assert err1 >= 10 * err3, (err1, err3)


@pytest.mark.parametrize("causal,D", CASES)
def test_bf16_finalize_with_p_rounded_within_flash_tol_of_plain(causal, D):
    q, k, v = _inputs(D, dtype=torch.bfloat16)
    o, lse = _emulate(q, k, v, "bf16", causal)
    o0, lse0 = flash_attention_plain(q, k, v, causal)
    assert float((o.bfloat16().float() - o0.float()).abs().max()) \
        <= BF16_O_ATOL
    assert float((lse - lse0).abs().max()) <= LSE_ATOL


@pytest.mark.parametrize("diag,D", CASES)
def test_bf16_carry_needs_p_as_hi_plus_lo(diag, D):
    """The carry's fp32 state is held to 2e-5 of its own scale: P as a
    bf16 hi + lo pair stays inside, a single bf16 P (2^-9 a term) does
    not."""
    q, k, v = _inputs(D, dtype=torch.bfloat16)
    want = flash_attention_carry_plain(q, k, v, *_state(D), diag)
    split = _emulate(q, k, v, "bf16_split", diag, state=_state(D))
    single = _emulate(q, k, v, "bf16", diag, state=_state(D))
    assert max(_carry_errs(split, want)) <= CARRY_RTOL
    assert _carry_errs(single, want)[2] > 5 * CARRY_RTOL


def test_attention_projections_and_ring_shards_reach_the_kernels_as_is():
    """The attention layer's q/k/v projections and the ring's sequence
    shards of them are already in the kernels' layout: `_kernel_layout`
    returns them without a copy."""
    mha = MultiHeadAttention(64, 2, causal=True)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 32, 64)).astype(np.float32))
    for t in mha._qkv(x):
        assert _kernel_layout(t) is t
        for c in shard(t, ["cpu"] * 4):
            assert _kernel_layout(c) is c
