"""The port's training kernels against the JAX package.

On the CPU each wrapper runs its plain PyTorch version; the JAX side
runs the Pallas kernels in interpret mode (through `jax.vjp` of their
custom_vjp), as the JAX suite does. Inputs come from numpy with a seed.
The CUDA kernels themselves are held against the plain versions on the
card (the `cuda`-marked tests here, and `chip_smoke.py`).

Tolerances (fp32): LayerNorm backward atol 1e-5 (fp32 row reductions in
another order); flash backward atol 1e-4 (dq/dk/dv are sums over up to
64 keys or queries of products of recomputed probabilities, in another
order than the Pallas tiles); Adam rtol 1e-6 (the same expression tree;
XLA:CPU and PyTorch may round the float32 power 1 - b^t differently in
the last bit).
"""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.common.updaters import Adam as JaxAdam
from deeplearning4j_tpu.kernels.flash_attention import (
    flash_attention as jax_flash,
)
from deeplearning4j_tpu.kernels.layernorm import (
    layer_norm as jax_ln,
    residual_layer_norm as jax_res_ln,
)
from deeplearning4j_tpu_torch import kernels as K
from deeplearning4j_tpu_torch.common.updaters import Adam, Sgd
from deeplearning4j_tpu_torch.kernels import build
from deeplearning4j_tpu_torch.kernels.flash_attention import (
    attention_delta,
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dkv_plain,
    flash_attention_bwd_dq,
    flash_attention_bwd_dq_plain,
    flash_attention_fwd,
)
from deeplearning4j_tpu_torch.kernels.fused_adam import (
    adam_update_packed,
    adam_update_plain,
)
from deeplearning4j_tpu_torch.kernels.layernorm import (
    layer_norm,
    ln_bwd_math,
    residual_layer_norm,
)

LN_ATOL = 1e-5
FLASH_ATOL = 1e-4
ADAM_RTOL = 1e-6


def _rand(shape, seed, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            + shift).astype(np.float32)


def _leaf(a):
    return torch.from_numpy(a.copy()).requires_grad_(True)


# ------------------------------------------------------------- LayerNorm
@pytest.mark.parametrize("shape", [(4, 7, 32), (13, 33)])
def test_layer_norm_backward_matches_jax_vjp(shape):
    D = shape[-1]
    x, g, b = _rand(shape, 0, 2, 0.5), _rand(D, 1, 0.1, 1), _rand(D, 2)
    gy = _rand(shape, 3)
    _, vjp = jax.vjp(lambda x_, g_, b_: jax_ln(x_, g_, b_, 1e-5, 8, True),
                     jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    want = vjp(jnp.asarray(gy))
    tx, tg, tb = _leaf(x), _leaf(g), _leaf(b)
    layer_norm(tx, tg, tb, 1e-5).backward(torch.from_numpy(gy))
    for got, w in zip((tx.grad, tg.grad, tb.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=LN_ATOL,
                                   rtol=0)


@pytest.mark.parametrize("shape", [(3, 9, 16), (17, 31)])
def test_residual_layer_norm_backward_matches_jax_vjp(shape):
    D = shape[-1]
    x, h = _rand(shape, 4, 2, 0.5), _rand(shape, 5)
    g, b = _rand(D, 6, 0.1, 1), _rand(D, 7)
    gs, gy = _rand(shape, 8), _rand(shape, 9)
    _, vjp = jax.vjp(
        lambda *a: jax_res_ln(*a, 1e-5, 8, True),
        *(jnp.asarray(a) for a in (x, h, g, b)))
    want = vjp((jnp.asarray(gs), jnp.asarray(gy)))
    t = [_leaf(a) for a in (x, h, g, b)]
    s, y = residual_layer_norm(*t, 1e-5)
    torch.autograd.backward((s, y), (torch.from_numpy(gs),
                                     torch.from_numpy(gy)))
    for got, w in zip(t, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w),
                                   atol=LN_ATOL, rtol=0)


def test_ln_bwd_math_is_the_autograd_of_the_plain_forward():
    """The analytic backward equals autograd through the plain fp32
    forward (no rounding of the normalised value in fp32)."""
    x, g, b = _rand((6, 24), 10, 2), _rand(24, 11, 0.1, 1), _rand(24, 12)
    gy = _rand((6, 24), 13)
    tx, tg, tb = _leaf(x), _leaf(g), _leaf(b)
    torch.nn.functional.layer_norm(tx, (24,), tg, tb, 1e-5).backward(
        torch.from_numpy(gy))
    x32 = torch.from_numpy(x)
    mean = x32.mean(-1, keepdim=True)
    rstd = 1 / torch.sqrt(x32.var(-1, keepdim=True, correction=0) + 1e-5)
    dx, dg, db = ln_bwd_math(torch.from_numpy(gy), torch.from_numpy(g), x32,
                             mean, rstd, torch.float32)
    for got, want in ((dx, tx.grad), (dg, tg.grad), (db, tb.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=LN_ATOL)


# -------------------------------------------------------- flash backward
def _flash_case(B, Tq, H, D, seed, Tk=None):
    Tk = Tq if Tk is None else Tk
    return (_rand((B, Tq, H, D), seed), _rand((B, Tk, H, D), seed + 1),
            _rand((B, Tk, H, D), seed + 2), _rand((B, Tq, H, D), seed + 3))


@pytest.mark.parametrize("causal,Tq,Tk", [(True, 45, None), (False, 45, None),
                                          (True, 64, None),
                                          (False, 37, 29)])
def test_flash_backward_matches_jax_vjp(causal, Tq, Tk):
    """16-row Pallas tiles: several q and k tiles, the causal skip and a
    ragged tail on the JAX side; the port through `_FlashAttentionFn`
    and through the plain dq / dkv functions."""
    q, k, v, do = _flash_case(2, Tq, 2, 8, 20, Tk)
    _, vjp = jax.vjp(lambda q_, k_, v_: jax_flash(q_, k_, v_, causal, 16,
                                                  16, True),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = [np.asarray(w) for w in vjp(jnp.asarray(do))]
    tq, tk, tv = _leaf(q), _leaf(k), _leaf(v)
    flash_attention(tq, tk, tv, causal).backward(torch.from_numpy(do))
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), w, atol=FLASH_ATOL, rtol=0)
    q_, k_, v_, do_ = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = flash_attention_fwd(q_, k_, v_, causal)
    delta = attention_delta(do_, o)
    dq = flash_attention_bwd_dq_plain(q_, k_, v_, do_, lse, delta, causal)
    dk, dv = flash_attention_bwd_dkv_plain(q_, k_, v_, do_, lse, delta,
                                           causal)
    for got, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(got.numpy(), w, atol=FLASH_ATOL, rtol=0)


def test_flash_backward_matches_autograd_of_masked_softmax():
    """Independent of JAX: the custom backward equals autograd through a
    plain -inf masked softmax attention."""
    q, k, v, do = _flash_case(1, 21, 3, 32, 30)
    tq, tk, tv = _leaf(q), _leaf(k), _leaf(v)
    flash_attention(tq, tk, tv, True).backward(torch.from_numpy(do))
    rq, rk, rv = _leaf(q), _leaf(k), _leaf(v)
    s = torch.einsum("bqhd,bkhd->bhqk", rq, rk) / np.sqrt(32)
    s = s.masked_fill(~torch.ones(21, 21, dtype=torch.bool).tril(),
                      float("-inf"))
    torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), rv).backward(
        torch.from_numpy(do))
    for got, want in ((tq, rq), (tk, rk), (tv, rv)):
        np.testing.assert_allclose(got.grad.numpy(), want.grad.numpy(),
                                   atol=FLASH_ATOL)


# -------------------------------------------------------------- fused Adam
def _adam_leaves(seed):
    shapes = [(7, 5), (5,), (3, 4, 2)]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def test_adam_plain_matches_jax_adam_apply_over_steps():
    ps = _adam_leaves(0)
    tp = [torch.from_numpy(p.copy()) for p in ps]
    tm = [torch.zeros_like(p) for p in tp]
    tv = [torch.zeros_like(p) for p in tp]
    jupd = JaxAdam(1e-3)
    jp = [jnp.asarray(p) for p in ps]
    js = [jupd.init_state(p) for p in jp]
    for step in range(5):
        gs = _adam_leaves(100 + step)
        adam_update_plain(Adam(1e-3), tp, [torch.from_numpy(g) for g in gs],
                          tm, tv, step)
        for i, g in enumerate(gs):
            upd, js[i] = jupd.apply(jnp.asarray(g), js[i], step)
            jp[i] = jp[i] - upd
    for i in range(len(ps)):
        for got, want in ((tp[i], jp[i]), (tm[i], js[i]["m"]),
                          (tv[i], js[i]["v"])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=ADAM_RTOL, atol=0)


def test_adam_packed_on_cpu_is_the_plain_version_and_bf16_grads_upcast():
    ps, gs = _adam_leaves(1), _adam_leaves(2)
    a = [torch.from_numpy(p.copy()) for p in ps]
    b = [torch.from_numpy(p.copy()) for p in ps]
    ma, va = [torch.zeros_like(p) for p in a], [torch.zeros_like(p) for p in a]
    mb, vb = [torch.zeros_like(p) for p in b], [torch.zeros_like(p) for p in b]
    g16 = [torch.from_numpy(g).to(torch.bfloat16) for g in gs]
    K.reset_launches()
    adam_update_packed(Adam(1e-3), a, g16, ma, va, 3)
    adam_update_plain(Adam(1e-3), b, [g.float() for g in g16], mb, vb, 3)
    for x, y in zip(a + ma + va, b + mb + vb):
        assert torch.equal(x, y)
    assert K.LAUNCHES["fused_adam"] == 0
    with pytest.raises(TypeError):
        adam_update_packed(Sgd(1e-3), a, g16, ma, va, 0)


def test_training_wrappers_never_launch_or_build_on_cpu(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("build reached from a CPU tensor")
    monkeypatch.setattr(build, "build_all", no_build)
    monkeypatch.setattr(build, "load", no_build)
    K.reset_launches()
    q, k, v = (_leaf(a) for a in _flash_case(1, 8, 1, 32, 50)[:3])
    flash_attention(q, k, v, True).sum().backward()
    x = _leaf(_rand((4, 32), 51))
    g, b = _leaf(_rand(32, 52)), _leaf(_rand(32, 53))
    (layer_norm(x, g, b).sum() + residual_layer_norm(x, x, g, b)[1].sum()
     ).backward()
    p = [torch.zeros(3)]
    adam_update_packed(Adam(), p, [torch.ones(3)], [torch.zeros(3)],
                       [torch.zeros(3)], 0)
    assert all(n == 0 for n in K.LAUNCHES.values())


def test_kernel_layout_copies_only_what_the_kernels_cannot_stage():
    """The backward kernels stage rows with 16-byte copies: a tensor with
    D contiguous and 16-byte aligned rows is passed as it is; a strided
    head dim or a view that starts off alignment is copied."""
    from deeplearning4j_tpu_torch.kernels.flash_attention import (
        _kernel_layout)
    x = torch.zeros(2, 8, 3, 32)
    assert _kernel_layout(x) is x
    assert _kernel_layout(x[:, 4:]).data_ptr() == x[:, 4:].data_ptr()
    for bad in (x.transpose(-1, -2).contiguous().transpose(-1, -2),
                torch.zeros(x.numel() + 1)[1:].view(x.shape)):
        out = _kernel_layout(bad)
        assert out.data_ptr() != bad.data_ptr() and out.is_contiguous()
        assert torch.equal(out, bad)


# --------------------------------------------------- on the card (skip here)
@pytest.mark.cuda
@pytest.mark.parametrize("Tq,Tk", [(300, 300), (300, 200), (200, 300)])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2 ** -5)])
def test_cuda_flash_backward_kernels_match_plain(D, dtype, atol, Tq, Tk):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v, do = (torch.from_numpy(a).to("cuda", dtype)
                   for a in _flash_case(2, Tq, 3, D, 60, Tk))
    for causal in (True, False):
        o, lse = flash_attention_fwd(q, k, v, causal)
        delta = attention_delta(do, o)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
        dq0 = flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
        dk0, dv0 = flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                 causal)
        for got, want in ((dq, dq0), (dk, dk0), (dv, dv0)):
            torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                       rtol=0)


@pytest.mark.cuda
def test_cuda_fused_adam_bit_equal_to_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ps, gs = _adam_leaves(3), _adam_leaves(4)
    a = [torch.from_numpy(p).cuda() for p in ps]
    b = [t.clone() for t in a]
    ma = [torch.full_like(t, 0.01) for t in a]
    va = [torch.full_like(t, 0.02) for t in a]
    mb, vb = [t.clone() for t in ma], [t.clone() for t in va]
    g = [torch.from_numpy(x).cuda() for x in gs]
    adam_update_packed(Adam(1e-3), a, g, ma, va, 7)
    adam_update_plain(Adam(1e-3), b, g, mb, vb, 7)
    for x, y in zip(a + ma + va, b + mb + vb):
        assert torch.equal(x, y)
