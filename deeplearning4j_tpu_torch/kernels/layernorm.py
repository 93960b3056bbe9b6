"""LayerNorm and residual+LayerNorm: CUDA forward kernel + plain
version, and the autograd functions around them.

Counterpart of `deeplearning4j_tpu/kernels/layernorm.py` (`layer_norm`,
`residual_layer_norm`, kernels `_ln_kernel` :55 and
`_residual_ln_kernel` :67). The CUDA source is `csrc/layernorm.cu`; its
note gives the bound (device-memory bytes) and the design. Launch
geometry, chosen in the C entry by the width D: up to 1024 a warp owns a
row and keeps it in registers (8 warps a block, at most 8 blocks an SM,
the warps striding over the rows), with 16-byte loads when D and the
pointers allow them and scalar loads on a ragged width; wider rows, up
to `MAX_D`, take a block each with the row staged in shared memory.

The backward (`_LayerNormFn`, `_ResidualLayerNormFn`) is
`ln_bwd_math` in plain PyTorch ops on every device: the JAX custom_vjp
(`_ln_bwd` :165, `_res_ln_bwd` :211, `_ln_bwd_math` :123) computes it
with jnp too, not with a Pallas kernel. It reads the fp32 `mean`/`rstd`
the forward saved; the residual form sends `ds = gs + dLN(gy)` to both
legs.

Semantics (the Pallas kernel's): row statistics in fp32 over the last
axis with the POPULATION variance, `rstd = 1/sqrt(var + eps)`; the
normalised row is rounded to `x.dtype` before `* gamma + beta`, each
step in `x.dtype`. The forward returns the fp32 `mean`/`rstd` [R, 1]
as the JAX forward saves them.
"""

from __future__ import annotations

import ctypes

import torch

from deeplearning4j_tpu_torch import kernels as K
from deeplearning4j_tpu_torch.kernels import build

MAX_D = 12288        # a wide row lives in 48 KB of shared memory


# ------------------------------------------------------------ plain versions
def _stats(x32: torch.Tensor, eps: float):
    mean = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(dim=-1, keepdim=True)
    rstd = 1.0 / torch.sqrt(var + eps)
    return mean, rstd


def layer_norm_plain(x, gamma, beta, eps: float = 1e-5):
    """Plain PyTorch version of the kernel: (y, mean [R, 1], rstd [R, 1])."""
    D = x.shape[-1]
    x32 = K.acc32(x.reshape(-1, D))
    mean, rstd = _stats(x32, eps)
    norm = ((x32 - mean) * rstd).to(x.dtype)
    y = norm * gamma + beta
    return y.reshape(x.shape), mean, rstd


def residual_layer_norm_plain(x, h, gamma, beta, eps: float = 1e-5):
    """Plain version of the fused residual form: (s, y, mean, rstd)."""
    s = x + h
    y, mean, rstd = layer_norm_plain(s, gamma, beta, eps)
    return s, y, mean, rstd


# --------------------------------------------------------------- the kernel
def _lib():
    lib = build.load("layernorm")
    fn = lib.dl4j_layer_norm_fwd
    if fn.argtypes is None:
        P = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int, ctypes.c_int, P, P, P, P, P, P, P, P,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float, P]
        fn.restype = ctypes.c_int
    return fn


def _check(x, gamma, beta, h=None):
    D = x.shape[-1]
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t.shape != (D,):
            raise ValueError(f"{name} must be [{D}]; got {tuple(t.shape)}")
    ts = (x, gamma, beta) if h is None else (x, h, gamma, beta)
    for t in ts:
        if t.dtype != x.dtype:
            raise TypeError(f"all operands must be {x.dtype}; got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("layer_norm kernel needs contiguous operands")
        if t.device != x.device:
            raise ValueError("operands on different devices")
    if h is not None and h.shape != x.shape:
        raise ValueError(f"h {tuple(h.shape)} must match x {tuple(x.shape)}")
    if not 0 < D <= MAX_D:
        raise ValueError(f"feature width {D} outside (0, {MAX_D}]")
    K.dtype_code(x)


def _launch(x, h, gamma, beta, eps):
    D = x.shape[-1]
    R = x.numel() // D
    residual = h is not None
    y = torch.empty_like(x)
    s = torch.empty_like(x) if residual else None
    mean = torch.empty((R, 1), dtype=torch.float32, device=x.device)
    rstd = torch.empty((R, 1), dtype=torch.float32, device=x.device)
    null = ctypes.c_void_p(0)
    status = _lib()(K.dtype_code(x), int(residual), K.ptr(x),
                    K.ptr(h) if residual else null, K.ptr(gamma),
                    K.ptr(beta), K.ptr(s) if residual else null, K.ptr(y),
                    K.ptr(mean), K.ptr(rstd), R, D, float(eps),
                    K.stream_of(x))
    K.check_status("layer_norm", status)
    return s, y, mean, rstd


# ---------------------------------------------------------------- wrappers
def layer_norm_fwd(x, gamma, beta, eps: float = 1e-5):
    """[..., D] -> (y [..., D], mean [R, 1], rstd [R, 1]). CUDA tensors
    launch the kernel; CPU tensors take the plain version."""
    if not K.on_cuda(x, gamma, beta):
        return layer_norm_plain(x, gamma, beta, eps)
    _check(x, gamma, beta)
    _, y, mean, rstd = _launch(x, None, gamma, beta, eps)
    K.count_launch("layer_norm", x.dtype)
    return y, mean, rstd


def residual_layer_norm_fwd(x, h, gamma, beta, eps: float = 1e-5):
    """Fused ``s = x + h; y = LayerNorm(s)`` -> (s, y, mean, rstd)."""
    if not K.on_cuda(x, h, gamma, beta):
        return residual_layer_norm_plain(x, h, gamma, beta, eps)
    _check(x, gamma, beta, h)
    s, y, mean, rstd = _launch(x, h, gamma, beta, eps)
    K.count_launch("residual_layer_norm", x.dtype)
    return s, y, mean, rstd


# ---------------------------------------------------------------- backward
def ln_bwd_math(gy, gamma, x32, mean, rstd, out_dtype):
    """Analytic LayerNorm backward from the saved fp32 statistics
    (the JAX `_ln_bwd_math`): dx = rstd·(ĝ − mean(ĝ) − x̂·mean(ĝ·x̂))
    with ĝ = gy·gamma, dγ = Σ gy·x̂ and dβ = Σ gy, reduced in fp32.
    gy/x32 are [R, D]."""
    xhat = (x32 - mean) * rstd
    gy32 = K.acc32(gy)
    g32 = gy32 * K.acc32(gamma)
    gmean = g32.mean(dim=-1, keepdim=True)
    gxmean = (g32 * xhat).mean(dim=-1, keepdim=True)
    dx = (rstd * (g32 - gmean - xhat * gxmean)).to(out_dtype)
    return dx, (gy32 * xhat).sum(dim=0), gy32.sum(dim=0)


class _LayerNormFn(torch.autograd.Function):
    """y = LayerNorm(x): the forward kernel (or its plain version on the
    CPU), the backward `ln_bwd_math`."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        y, mean, rstd = layer_norm_fwd(x, gamma, beta, eps)
        ctx.save_for_backward(x, gamma, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, gamma, mean, rstd = ctx.saved_tensors
        D = x.shape[-1]
        dx, dgamma, dbeta = ln_bwd_math(gy.reshape(-1, D), gamma,
                                        K.acc32(x.reshape(-1, D)), mean,
                                        rstd, x.dtype)
        return (dx.reshape(x.shape), dgamma.to(gamma.dtype),
                dbeta.to(gamma.dtype), None)


class _ResidualLayerNormFn(torch.autograd.Function):
    """(s, y) = (x + h, LayerNorm(x + h)): the fused forward kernel, the
    backward `ds = gs + dLN(gy)` into both x and h."""

    @staticmethod
    def forward(ctx, x, h, gamma, beta, eps):
        s, y, mean, rstd = residual_layer_norm_fwd(x, h, gamma, beta, eps)
        ctx.save_for_backward(s, gamma, mean, rstd)
        return s, y

    @staticmethod
    def backward(ctx, gs, gy):
        s, gamma, mean, rstd = ctx.saved_tensors
        D = s.shape[-1]
        dln, dgamma, dbeta = ln_bwd_math(gy.reshape(-1, D), gamma,
                                         K.acc32(s.reshape(-1, D)), mean,
                                         rstd, s.dtype)
        ds = gs + dln.reshape(s.shape)
        return (ds, ds, dgamma.to(gamma.dtype), dbeta.to(gamma.dtype),
                None)


def layer_norm(x, gamma, beta, eps: float = 1e-5):
    """[..., D] -> [..., D] (the JAX `layer_norm` signature),
    differentiable."""
    return _LayerNormFn.apply(x, gamma, beta, eps)


def residual_layer_norm(x, h, gamma, beta, eps: float = 1e-5):
    """(s, y) — the JAX `residual_layer_norm` signature, differentiable."""
    return _ResidualLayerNormFn.apply(x, h, gamma, beta, eps)
