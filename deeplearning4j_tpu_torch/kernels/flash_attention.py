"""Flash attention: the forward in its two modes and the two backward
CUDA kernels, each with its plain version, and the autograd function
around them.

Counterpart of `deeplearning4j_tpu/kernels/flash_attention.py`
`flash_attention` (a `jax.custom_vjp`): the forward `_flash_fwd_kernel`
:87 in finalize mode (`csrc/flash_attention.cu`), and the backward
`_flash_bwd_dq_kernel` :265 and `_flash_bwd_dkv_kernel` :307
(`csrc/flash_attention_bwd.cu`). All three run on the tensor cores
(`mma.sync`: bf16, and 3xTF32 for fp32) on the tiles of
`csrc/flash_tiles.cuh`; each source's note gives its bound and its
design. `_FlashAttentionFn` is the custom_vjp: the forward kernel saves
(q, k, v, o, lse), the backward launches the dQ and the dK/dV kernels.
Unlike the JAX package, the backward takes the kernels at every
sequence length (its `_PALLAS_BWD_MIN_T` crossover to XLA was measured
on a TPU). `flash_attention_carry` runs the forward kernel in carry mode
(the JAX `flash_attention_carry` :245): it folds one K/V chunk into a
running (m, l, acc) state, the step of the ring attention in
`parallel/ring.py`; in bf16 it carries P as a bf16 hi + lo pair, so the
fp32 state keeps fp32's accuracy.

Layout: every kernel reads q, k, v (and dO) through their [B, T, H, D]
strides and stages rows with 16-byte copies, so the head dim must be
contiguous and every row 16-byte aligned. `_kernel_layout` copies a
tensor only when it is not (a strided head dim, a view that starts off
alignment); the projections of the attention layer and the ring's
sequence shards pass through as they are. The kernels are built for
head dims 32, 64 and 128; a smaller head dim (the Pallas kernel takes
any) is zero-padded to the next of them on its way in (`_pad_head`) and
the outputs cut back, with the scale of the real head dim: a zero
column adds nothing to q·k, and its columns of o, dq, dk, dv come out
zero, so the kernel computes the same function.

Semantics (the Pallas kernel's): q, k, v [B, T, H, D]; scores
`(q * 1/sqrt(D)) k^T` in fp32; causal mask `k_pos <= q_pos` and the
ragged tail masked with -1e30 (not -inf: a masked score contributes
exp(-1e30 - m) == 0); o [B, Tq, H, D] in q's dtype and
lse = m + log(max(l, 1e-20)) [B, H, Tq] in fp32. The backward
recomputes p = exp((q·k)·scale − lse) under the same masks, with
Δ = rowsum(dO∘O) [B, H, Tq] (`attention_delta`, a torch op as it is a
jnp einsum in JAX); dq/dk/dv come out in the inputs' dtype.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from deeplearning4j_tpu_torch import kernels as K
from deeplearning4j_tpu_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)


def _kernel_dim(D: int) -> int:
    """The smallest head dim the kernels are built for that holds D."""
    for d in HEAD_DIMS:
        if D <= d:
            return d
    raise ValueError(f"head dim {D} above the kernels' {HEAD_DIMS[-1]}")


def _pad_head(t, Dk: int):
    """`t` [..., D] zero-padded to [..., Dk] (itself when D == Dk)."""
    D = t.shape[-1]
    if D == Dk:
        return t
    return torch.nn.functional.pad(t, (0, Dk - D))


def _scale(D: int) -> float:
    # 1/sqrt(D) in double, then used as an fp32 multiplier — the JAX
    # kernel's `1.0 / float(np.sqrt(D))`
    return float(np.float32(1.0 / float(np.sqrt(D))))


# ------------------------------------------------------------ plain version
def flash_attention_plain(q, k, v, causal: bool = False):
    """Plain PyTorch version of the kernel: (o [B, Tq, H, D], lse [B, H, Tq]).
    Materialises the [Tq, Tk] scores — the same function, not the same
    memory behaviour."""
    Tq, Tk, D = q.shape[1], k.shape[1], q.shape[-1]
    qf = K.acc32(q) * _scale(D)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, K.acc32(k))
    if causal:
        qpos = torch.arange(Tq, device=q.device)[:, None]
        kpos = torch.arange(Tk, device=q.device)[None, :]
        s = torch.where(kpos <= qpos, s, torch.full_like(s, NEG_INF))
    m = s.max(dim=-1, keepdim=True).values
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    o = torch.einsum("bhqk,bkhd->bqhd", p, K.acc32(v)) / l.permute(0, 2, 1, 3)
    lse = (m + torch.log(l))[..., 0]
    return o.to(q.dtype), lse


def flash_attention_carry_plain(q, k, v, m, l, acc, diag: bool):
    """Plain version of the carry fold (see `flash_attention_carry`):
    materialises the chunk's [Tq, Tk] scores. Updates m, l, acc in place
    and returns them."""
    Tq, Tk, D = q.shape[1], k.shape[1], q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", K.acc32(q) * _scale(D), K.acc32(k))
    if diag:
        qpos = torch.arange(Tq, device=q.device)[:, None]
        kpos = torch.arange(Tk, device=q.device)[None, :]
        s = torch.where(kpos <= qpos, s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.max(dim=-1).values)
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l.mul_(corr).add_(p.sum(dim=-1))
    acc.mul_(corr[..., None]).add_(
        torch.einsum("bhqk,bkhd->bhqd", p, K.acc32(v)))
    m.copy_(m_new)
    return m, l, acc


# --------------------------------------------------------------- the kernel
def _lib(name: str = "dl4j_flash_attention_fwd"):
    fn = getattr(build.load("flash_attention"), name)
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        outs = [P, P] if name.endswith("_fwd") else [P, P, P]
        fn.argtypes = [I, I, P, P, P, *outs, I, I, I, I, I,
                       ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, P]
        fn.restype = ctypes.c_int
    return fn


def _bwd_lib(name: str):
    fn = getattr(build.load("flash_attention_bwd"), name)
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        outs = [P] if name.endswith("_dq") else [P, P]
        fn.argtypes = [I, I, P, P, P, P, P, P, *outs, I, I, I, I, I,
                       ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, P]
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, T, H, D]")
    B, Tq, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (H, D):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    for t in (q, k, v):
        if t.dtype != q.dtype:
            raise TypeError(f"q, k, v dtypes differ: {q.dtype} vs {t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError("flash kernel needs the head dim contiguous")
        if t.device != q.device:
            raise ValueError("q, k, v on different devices")
    if k.shape[1] < 1:
        raise ValueError("empty key sequence")
    K.dtype_code(q)


def _kernel_layout(t):
    # the kernels read every tensor through its strides but stage
    # rows with 16-byte copies: D contiguous and every row 16-byte aligned.
    # Autograd may hand over a gradient whose head dim is strided, and a
    # view may start off alignment; only then is a copy made
    es = t.element_size()
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s * es % 16 == 0 for s in t.stride()[:-1])):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def flash_attention_fwd(q, k, v, causal: bool = False):
    """(o, lse). CUDA tensors launch the kernel; CPU tensors take the
    plain version."""
    if not K.on_cuda(q, k, v):
        return flash_attention_plain(q, k, v, causal)
    D0 = q.shape[-1]
    Dk = _kernel_dim(D0)
    q, k, v = (_kernel_layout(_pad_head(t, Dk)) for t in (q, k, v))
    _check(q, k, v)
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    o = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 9)(
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2))
    status = _lib()(K.dtype_code(q), int(bool(causal)), K.ptr(q), K.ptr(k),
                    K.ptr(v), K.ptr(o), K.ptr(lse), B, Tq, Tk, H, D,
                    strides, _scale(D0), K.stream_of(q))
    K.check_status("flash_attention_fwd", status)
    K.count_launch("flash_attention_fwd", q.dtype)
    return o[..., :D0], lse


def _check_carry(q, k, v, m, l, acc, diag):
    if diag and q.shape[1] != k.shape[1]:
        raise ValueError(f"a diag fold needs Tq == Tk; got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    B, Tq, H, D = q.shape
    for name, t, shape in (("m", m, (B, H, Tq)), ("l", l, (B, H, Tq)),
                           ("acc", acc, (B, H, Tq, D))):
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or t.device != q.device):
            raise ValueError(f"{name} must be fp32 {list(shape)} on q's "
                             f"device; got {t.dtype} {tuple(t.shape)}")


def flash_attention_carry(q, k, v, m, l, acc, *, diag: bool):
    """Fold one K/V chunk into a running online-softmax state (the JAX
    `flash_attention_carry`). q [B, Tq, H, D]; k, v [B, Tk, H, D] (Tk may
    differ from Tq unless `diag`); m, l [B, H, Tq] fp32 (running max and
    denominator, start at m = -1e30, l = 0, never -inf); acc
    [B, H, Tq, D] fp32, the unnormalised output. `diag` masks
    k_pos > q_pos between local positions (the diagonal chunk of a
    causal ring); fully visible chunks pass diag=False, fully masked
    ones are not folded. Unlike the JAX function, the state is updated
    IN PLACE (each CUDA block owns its rows) and returned. CUDA tensors
    launch the kernel; CPU tensors take the plain version."""
    _check_carry(q, k, v, m, l, acc, diag)
    if not K.on_cuda(q, k, v, m, l, acc):
        return flash_attention_carry_plain(q, k, v, m, l, acc, diag)
    D0 = q.shape[-1]
    Dk = _kernel_dim(D0)
    q, k, v = (_kernel_layout(_pad_head(t, Dk)) for t in (q, k, v))
    _check(q, k, v)
    for name, t in (("m", m), ("l", l), ("acc", acc)):
        if not t.is_contiguous():
            raise ValueError(f"carry state {name} must be contiguous")
    acc_k = _pad_head(acc, Dk).contiguous()
    B, Tq, H, D = q.shape
    strides = (ctypes.c_longlong * 9)(
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2))
    status = _lib("dl4j_flash_attention_carry")(
        K.dtype_code(q), int(bool(diag)), K.ptr(q), K.ptr(k), K.ptr(v),
        K.ptr(m), K.ptr(l), K.ptr(acc_k), B, Tq, k.shape[1], H, D, strides,
        _scale(D0), K.stream_of(q))
    K.check_status("flash_attention_carry", status)
    K.count_launch("flash_attention_carry", q.dtype)
    if acc_k is not acc:
        acc.copy_(acc_k[..., :D0])
    return m, l, acc


# ----------------------------------------------------------------- backward
def attention_delta(do, o):
    """Δ [B, H, T] = Σ_d dO·O in fp32 — the per-row term both backward
    kernels read (the JAX `attention_delta`)."""
    return torch.einsum("bthd,bthd->bht", K.acc32(do), K.acc32(o))


def _probs(q, k, lse, causal):
    """p = exp(s − lse) [B, H, Tq, Tk] with s = (q·k)·scale under the
    kernels' masks (-1e30) — recomputed from lse, as the kernels do."""
    Tq, Tk, D = q.shape[1], k.shape[1], q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", K.acc32(q), K.acc32(k)) * _scale(D)
    if causal:
        qpos = torch.arange(Tq, device=q.device)[:, None]
        kpos = torch.arange(Tk, device=q.device)[None, :]
        s = torch.where(kpos <= qpos, s, torch.full_like(s, NEG_INF))
    return torch.exp(s - lse[..., None])


def _dscores(q, k, v, do, lse, delta, causal):
    p = _probs(q, k, lse, causal)
    dp = torch.einsum("bqhd,bkhd->bhqk", K.acc32(do), K.acc32(v))
    return p, p * (dp - delta[..., None])


def flash_attention_bwd_dq_plain(q, k, v, do, lse, delta,
                                 causal: bool = False):
    """Plain version of the dQ kernel: dQ = scale·Σ_k dS·K, [B, Tq, H, D]
    in q's dtype."""
    _, ds = _dscores(q, k, v, do, lse, delta, causal)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, K.acc32(k)) * _scale(q.shape[-1])
    return dq.to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta,
                                  causal: bool = False):
    """Plain version of the dK/dV kernel: (dK = scale·Σ_q dSᵀ·Q,
    dV = Σ_q Pᵀ·dO), [B, Tk, H, D] each in k's dtype."""
    p, ds = _dscores(q, k, v, do, lse, delta, causal)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, K.acc32(do))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, K.acc32(q)) * _scale(q.shape[-1])
    return dk.to(k.dtype), dv.to(v.dtype)


def _check_bwd(q, k, v, do, lse, delta):
    _check(q, k, v)
    B, Tq, H, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"do {tuple(do.shape)} {do.dtype} must match q")
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != (B, H, Tq) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{name} must be a contiguous fp32 "
                             f"[{B}, {H}, {Tq}] on q's device")


def _bwd_strides(q, k, v, do):
    return (ctypes.c_longlong * 12)(*(t.stride(i) for t in (q, k, v, do)
                                      for i in range(3)))


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal: bool = False):
    """dQ [B, Tq, H, D]. CUDA tensors launch the kernel; CPU tensors
    take the plain version."""
    if not K.on_cuda(q, k, v, do, lse, delta):
        return flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal)
    D0 = q.shape[-1]
    Dk = _kernel_dim(D0)
    q, k, v, do = (_kernel_layout(_pad_head(t, Dk)) for t in (q, k, v, do))
    _check_bwd(q, k, v, do, lse, delta)
    B, Tq, H, D = q.shape
    dq = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    status = _bwd_lib("dl4j_flash_attention_bwd_dq")(
        K.dtype_code(q), int(bool(causal)), K.ptr(q), K.ptr(k), K.ptr(v),
        K.ptr(do), K.ptr(lse), K.ptr(delta), K.ptr(dq), B, Tq, k.shape[1],
        H, D, _bwd_strides(q, k, v, do), _scale(D0), K.stream_of(q))
    K.check_status("flash_attention_bwd_dq", status)
    K.count_launch("flash_attention_bwd_dq", q.dtype)
    return dq[..., :D0]


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal: bool = False):
    """(dK, dV) [B, Tk, H, D]. CUDA tensors launch the kernel; CPU
    tensors take the plain version."""
    if not K.on_cuda(q, k, v, do, lse, delta):
        return flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal)
    D0 = q.shape[-1]
    Dk = _kernel_dim(D0)
    q, k, v, do = (_kernel_layout(_pad_head(t, Dk)) for t in (q, k, v, do))
    _check_bwd(q, k, v, do, lse, delta)
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    dk = torch.empty((B, Tk, H, D), dtype=k.dtype, device=k.device)
    dv = torch.empty((B, Tk, H, D), dtype=v.dtype, device=v.device)
    status = _bwd_lib("dl4j_flash_attention_bwd_dkv")(
        K.dtype_code(q), int(bool(causal)), K.ptr(q), K.ptr(k), K.ptr(v),
        K.ptr(do), K.ptr(lse), K.ptr(delta), K.ptr(dk), K.ptr(dv), B, Tq,
        Tk, H, D, _bwd_strides(q, k, v, do), _scale(D0), K.stream_of(q))
    K.check_status("flash_attention_bwd_dkv", status)
    K.count_launch("flash_attention_bwd_dkv", q.dtype)
    return dk[..., :D0], dv[..., :D0]


class _FlashAttentionFn(torch.autograd.Function):
    """The port's custom_vjp: forward kernel, then the dQ and dK/dV
    kernels (plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = bool(causal)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        delta = attention_delta(do, o)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, ctx.causal)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                         ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = False):
    """[B, T, H, D] x3 -> [B, T, H, D] (the JAX `flash_attention`; block
    sizes are the kernels' own 64x64 tiles), differentiable."""
    return _FlashAttentionFn.apply(q, k, v, causal)
