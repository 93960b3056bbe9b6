"""The rounding of the tensor-core flash backward kernels, emulated on the
CPU (`deeplearning4j_tpu_torch/kernels/csrc/flash_attention_bwd.cu`).

The CUDA kernels run only on the card; what they do to the numbers can
be replayed here in plain torch. Each product of the kernels is emulated
by rounding its operands as the tensor cores see them and summing the
exact products in float64:
- fp32 inputs, 3xTF32: x = hi + lo, both rounded to TF32 (cvt.rna), and
  a·b = lo·hi + hi·lo + hi·hi;
- fp32 inputs, 1xTF32 (what the kernels do not do): hi·hi only;
- bf16 inputs: S and dP from the inputs as they are, P and dS rounded
  to bf16 before the second products (dV = Pᵀ·dO, dK = dSᵀ·Q, dQ = dS·K).
The emulations are held against the JAX package's flash backward (the
Pallas kernels in interpret mode with 64-row tiles, a 2 x 2 grid at
T = 128) at the port's fp32 tolerance, against an fp64 reference for why
three passes are needed, and against the port's plain versions at the
2-ulp bf16 bound that `chip_smoke.py` holds the kernels to on the card.

What this does not emulate is the tensor cores' own fp32 accumulation,
which rounds toward zero: it is the larger part of the kernels' fp32
error on the card (about 1e-6 emulated here against 1.4e-5 measured at
T = 512 by `chip_smoke.py` phase 2, PERF.md), so the card's reading, not
this file, is what holds the kernels to 1e-4.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.kernels.flash_attention import (
    flash_attention as jax_flash,
)
from deeplearning4j_tpu_torch.kernels.flash_attention import (
    _scale,
    attention_delta,
    flash_attention_bwd_dkv_plain,
    flash_attention_bwd_dq_plain,
    flash_attention_fwd,
)

FLASH_ATOL = 1e-4     # the port's fp32 flash backward tolerance
CASES = [(causal, D) for causal in (True, False) for D in (32, 64)]


def _inputs(D, seed=70, dtype=torch.float32):
    """q, k, v, dO [1, 128, 2, D] from a numpy seed, in `dtype`."""
    rng = np.random.default_rng(seed + D)
    return [torch.from_numpy(rng.standard_normal((1, 128, 2, D)).astype(
        np.float32)).to(dtype) for _ in range(4)]


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits), ties away from zero: the
    kernels' cvt.rna.tf32.f32."""
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


def _mm_bf16(a, b):
    # operands already bf16 values; exact products, summed
    return (a.double() @ b.double()).float()


def _emulate(q, k, v, do, lse, delta, causal, mode):
    """(dq, dk, dv) [B, T, H, D] fp32 as the kernels round them: mode
    "3xtf32" or "1xtf32" for fp32 inputs, "bf16" for bf16 inputs."""
    mm = {"3xtf32": _mm_3xtf32, "1xtf32": _mm_1xtf32, "bf16": _mm_bf16}[mode]
    Q, K, V, dO = (t.float().permute(0, 2, 1, 3) for t in (q, k, v, do))
    T, Tk, D = Q.shape[2], K.shape[2], Q.shape[3]
    s = mm(Q, K.transpose(-1, -2)) * _scale(D)
    if causal:
        keep = torch.ones(T, Tk, dtype=torch.bool).tril()
        s = torch.where(keep, s, torch.full_like(s, -1e30))
    p = torch.exp(s - lse[..., None])
    ds = p * (mm(dO, V.transpose(-1, -2)) - delta[..., None])
    if mode == "bf16":                  # the A operand of the second products
        p, ds = p.bfloat16().float(), ds.bfloat16().float()
    dq = mm(ds, K) * _scale(D)
    dk = mm(ds.transpose(-1, -2), Q) * _scale(D)
    dv = mm(p.transpose(-1, -2), dO)
    return [t.permute(0, 2, 1, 3) for t in (dq, dk, dv)]


def _saved(q, k, v, do, causal):
    """lse from the port's forward and delta = rowsum(dO∘O), as
    `_FlashAttentionFn` hands them to the kernels."""
    o, lse = flash_attention_fwd(q, k, v, causal)
    return lse, attention_delta(do, o)


def _reference64(q, k, v, do, causal):
    """dq, dk, dv of plain attention in float64 (autograd)."""
    leaves = [t.double().requires_grad_() for t in (q, k, v)]
    Q, K, V = (t.permute(0, 2, 1, 3) for t in leaves)
    s = Q @ K.transpose(-1, -2) / np.sqrt(Q.shape[-1])
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool).tril()
        s = s.masked_fill(~keep, float("-inf"))
    o = (torch.softmax(s, -1) @ V).permute(0, 2, 1, 3)
    o.backward(do.double())
    return [t.grad for t in leaves]


@functools.lru_cache(maxsize=None)
def _jax_grads(causal, D):
    """dq, dk, dv of the JAX flash attention; under jit, where the
    interpreted kernels trace once instead of dispatching op by op."""
    def grads(q, k, v, do):
        _, vjp = jax.vjp(lambda *a: jax_flash(*a, causal, 64, 64, True),
                         q, k, v)
        return vjp(do)
    args = (jnp.asarray(t.numpy()) for t in _inputs(D))
    return [np.array(g) for g in jax.jit(grads)(*args)]


def _max_err(got, want):
    return max(float((torch.as_tensor(a).double()
                      - torch.as_tensor(b).double()).abs().max())
               for a, b in zip(got, want))


@pytest.mark.parametrize("causal,D", CASES)
def test_3xtf32_emulation_matches_jax_vjp(causal, D):
    q, k, v, do = _inputs(D)
    got = _emulate(q, k, v, do, *_saved(q, k, v, do, causal), causal,
                   "3xtf32")
    for g, w in zip(got, _jax_grads(causal, D)):
        np.testing.assert_allclose(g.numpy(), w, atol=FLASH_ATOL, rtol=0)


@pytest.mark.parametrize("causal,D", CASES)
def test_1xtf32_is_ten_times_further_off_than_3xtf32(causal, D):
    """Plain TF32 products would miss the fp32 tolerance; the split
    brings the error back to fp32's. Against fp64."""
    q, k, v, do = _inputs(D)
    saved = _saved(q, k, v, do, causal)
    want = _reference64(q, k, v, do, causal)
    err3 = _max_err(_emulate(q, k, v, do, *saved, causal, "3xtf32"), want)
    err1 = _max_err(_emulate(q, k, v, do, *saved, causal, "1xtf32"), want)
    assert err3 < 1e-5
    assert err1 >= 10 * err3, (err1, err3)


def _two_ulp(ref):
    """chip_smoke's bf16 backward bound: 2 bf16 ulp of the largest
    |value|."""
    m = max(float(r.float().abs().max()) for r in ref)
    return 2 * 2.0 ** (np.floor(np.log2(max(m, 2 ** -60))) - 7)


@pytest.mark.parametrize("causal,D", CASES)
def test_bf16_rounded_p_and_ds_within_two_ulp_of_plain(causal, D):
    q, k, v, do = _inputs(D, dtype=torch.bfloat16)
    lse, delta = _saved(q, k, v, do, causal)
    dq, dk, dv = (t.bfloat16() for t in _emulate(q, k, v, do, lse, delta,
                                                 causal, "bf16"))
    dq0 = flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal)
    dk0, dv0 = flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal)
    # grouped as chip_smoke checks them: dq alone, dk and dv together
    for got, ref in (((dq,), (dq0,)), ((dk, dv), (dk0, dv0))):
        assert _max_err(got, ref) <= _two_ulp(ref)
