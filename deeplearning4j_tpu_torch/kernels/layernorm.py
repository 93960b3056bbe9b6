"""LayerNorm and residual+LayerNorm forward: CUDA kernel + plain version.

Counterpart of `deeplearning4j_tpu/kernels/layernorm.py` (`layer_norm`,
`residual_layer_norm`, kernels `_ln_kernel` :55 and
`_residual_ln_kernel` :67). The CUDA source is `csrc/layernorm.cu`; its
note gives the bound (device-memory bytes) and the design (one block
per row, the row staged once in shared memory).

Semantics (the Pallas kernel's): row statistics in fp32 over the last
axis with the POPULATION variance, `rstd = 1/sqrt(var + eps)`; the
normalised row is rounded to `x.dtype` before `* gamma + beta`, each
step in `x.dtype`. The forward returns the fp32 `mean`/`rstd` [R, 1]
as the JAX forward saves them (the backward kernels of a later port
read them).
"""

from __future__ import annotations

import ctypes

import torch

from deeplearning4j_tpu_torch import kernels as K
from deeplearning4j_tpu_torch.kernels import build

MAX_D = 12288        # the row lives in 48 KB of shared memory


# ------------------------------------------------------------ plain versions
def _stats(x32: torch.Tensor, eps: float):
    mean = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(dim=-1, keepdim=True)
    rstd = 1.0 / torch.sqrt(var + eps)
    return mean, rstd


def layer_norm_plain(x, gamma, beta, eps: float = 1e-5):
    """Plain PyTorch version of the kernel: (y, mean [R, 1], rstd [R, 1])."""
    D = x.shape[-1]
    x32 = x.reshape(-1, D).float()
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
    K.LAUNCHES["layer_norm"] += 1
    return y, mean, rstd


def layer_norm(x, gamma, beta, eps: float = 1e-5):
    """[..., D] -> [..., D] (the JAX `layer_norm` signature)."""
    return layer_norm_fwd(x, gamma, beta, eps)[0]


def residual_layer_norm_fwd(x, h, gamma, beta, eps: float = 1e-5):
    """Fused ``s = x + h; y = LayerNorm(s)`` -> (s, y, mean, rstd)."""
    if not K.on_cuda(x, h, gamma, beta):
        return residual_layer_norm_plain(x, h, gamma, beta, eps)
    _check(x, gamma, beta, h)
    s, y, mean, rstd = _launch(x, h, gamma, beta, eps)
    K.LAUNCHES["residual_layer_norm"] += 1
    return s, y, mean, rstd


def residual_layer_norm(x, h, gamma, beta, eps: float = 1e-5):
    """(s, y) — the JAX `residual_layer_norm` signature."""
    s, y, _, _ = residual_layer_norm_fwd(x, h, gamma, beta, eps)
    return s, y
