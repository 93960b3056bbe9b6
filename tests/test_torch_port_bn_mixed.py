"""BatchNormalization under mixed_bf16 held to the JAX package's rounding
(`nn/layers/normalization.py:67-88`): fp32 statistics of the fp32 view,
``inv = 1 / sqrt(var + eps)`` in fp32, then ``(x - mean.bf16) *
inv.bf16`` and ``* gamma.bf16 + beta.bf16`` in bf16.

Tolerances: the forward bit for bit (`_ulps` counts the elements more
than 0 bf16 ulps apart; the contract allows 1 ulp on at most
MAX_ULP_FRACTION of them, and the CPU run shows none), gradients in the
bf16 band (BF16_BAND relative to each gradient's largest value, two
bf16 ulps: the backward's bf16 products and sums run in another order),
and the fp32 path (`F.batch_norm`) within FP32_RTOL of the largest |y|
(JAX's form measures 0 at inference and 1.4e-6 absolute in training at
|y| < 6; the library 1.9e-6 at |y| < 17, an fp32 ulp). The layer gets bf16 x and the bf16 copies of
gamma/beta, as the container's mixed step hands them over.
"""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.layers import normalization as jnorm
from deeplearning4j_tpu_torch.nn.layers import layer_from_dict

BF16_BAND = 2.0 ** -5
FP32_RTOL = 1e-6
MAX_ULP_FRACTION = 0.0


def _case(seed, shape, lock=False):
    rng = np.random.default_rng(seed)
    C = shape[-1]
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    jl = jnorm.BatchNormalization(n_out=C, lock_gamma_beta=lock, eps=1e-3)
    params = {} if lock else {
        "gamma": jnp.asarray(rng.normal(1.0, 0.5, C).astype(np.float32)),
        "beta": jnp.asarray(rng.normal(0.0, 0.5, C).astype(np.float32))}
    state = {"mean": jnp.asarray(rng.normal(size=C).astype(np.float32)),
             "var": jnp.asarray(rng.uniform(0.5, 2, C).astype(np.float32))}
    pl = layer_from_dict(jl.to_dict())
    pl.load_jax_params({k: np.asarray(v) for k, v in params.items()})
    pl.load_jax_state({k: np.asarray(v) for k, v in state.items()})
    return x, jl, params, state, pl


def _ulps(got, want):
    """Elements apart, in units of the bf16 ulp of JAX's value."""
    want = np.asarray(want, np.float32)
    ulp = np.maximum(np.abs(want), 2.0 ** -126) * 2.0 ** -7
    ulp = 2.0 ** np.floor(np.log2(ulp))
    return np.abs(np.asarray(got, np.float32) - want) / ulp


@pytest.mark.parametrize("train", [True, False], ids=["train", "infer"])
@pytest.mark.parametrize("lock", [False, True], ids=["affine", "locked"])
@pytest.mark.parametrize("shape", [(8, 5, 5, 24), (4, 7, 16), (32, 12)],
                         ids=["nhwc", "btf", "bf"])
def test_mixed_forward_is_jax_bit_for_bit(train, lock, shape):
    x, jl, params, state, pl = _case(3, shape, lock)
    jp = {k: v.astype(jnp.bfloat16) for k, v in params.items()}
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want, wst = jax.jit(lambda p, s, v: jl.forward(p, s, v, train=train))(
        jp, state, xb)
    assert want.dtype == jnp.bfloat16
    copies = {n: p.detach().to(torch.bfloat16)
              for n, p in pl.named_parameters()}
    got_state = {}
    y = torch.func.functional_call(
        pl, copies, (torch.from_numpy(x).to(torch.bfloat16),),
        dict(train=train, new_state=got_state))
    assert y.dtype == torch.bfloat16
    ulps = _ulps(y.float().numpy(), np.asarray(want.astype(jnp.float32)))
    assert ulps.max() <= 1.0, ulps.max()
    assert (ulps > 0).mean() <= MAX_ULP_FRACTION, (ulps > 0).sum()
    if train:
        for k in ("mean", "var"):
            np.testing.assert_allclose(got_state[k].numpy(),
                                       np.asarray(wst[k]), rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("train", [True, False], ids=["train", "infer"])
def test_mixed_gradients_within_the_bf16_band(train):
    x, jl, params, state, pl = _case(5, (4, 6, 6, 8))
    r = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)
    jp = {k: v.astype(jnp.bfloat16) for k, v in params.items()}

    def jf(p, v):
        y, _ = jl.forward(p, state, v, train=train)
        return jnp.sum(y.astype(jnp.float32) * r)
    gp, gx = jax.grad(jf, argnums=(0, 1))(
        jp, jnp.asarray(x).astype(jnp.bfloat16))
    copies = {n: p.detach().to(torch.bfloat16).requires_grad_(True)
              for n, p in pl.named_parameters()}
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    y = torch.func.functional_call(pl, copies, (xt,), dict(train=train))
    (y.float() * torch.from_numpy(r)).sum().backward()
    for got, want in ((xt.grad, gx), (copies["gamma"].grad, gp["gamma"]),
                      (copies["beta"].grad, gp["beta"])):
        got = got.float().numpy()
        want = np.asarray(want.astype(jnp.float32))
        err = np.abs(got - want).max()
        assert err <= BF16_BAND * np.abs(want).max(), err


@pytest.mark.parametrize("train", [True, False], ids=["train", "infer"])
def test_fp32_path_stays_on_the_library_within_1e6(train):
    x, jl, params, state, pl = _case(11, (8, 5, 5, 24))
    want, _ = jl.forward(params, state, jnp.asarray(x), train=train)
    y = pl(torch.from_numpy(x), train=train)
    want = np.asarray(want)
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=0,
                               atol=FP32_RTOL * np.abs(want).max())
