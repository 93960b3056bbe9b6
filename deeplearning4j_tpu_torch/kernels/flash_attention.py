"""Flash-attention forward: CUDA kernel + plain version.

Counterpart of `deeplearning4j_tpu/kernels/flash_attention.py`
`flash_attention` (forward only: `_flash_fwd_kernel` :87 in finalize
mode). The CUDA source is `csrc/flash_attention.cu`; its note gives the
bound and the design. Training (the two backward kernels) and the ring
carry mode are later slices of the port.

Semantics (the Pallas kernel's): q, k, v [B, T, H, D]; scores
`(q * 1/sqrt(D)) k^T` in fp32; causal mask `k_pos <= q_pos` and the
ragged tail masked with -1e30 (not -inf: a masked score contributes
exp(-1e30 - m) == 0); o [B, Tq, H, D] in q's dtype and
lse = m + log(max(l, 1e-20)) [B, H, Tq] in fp32.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from deeplearning4j_tpu_torch import kernels as K
from deeplearning4j_tpu_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)


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
    qf = q.float() * _scale(D)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, k.float())
    if causal:
        qpos = torch.arange(Tq, device=q.device)[:, None]
        kpos = torch.arange(Tk, device=q.device)[None, :]
        s = torch.where(kpos <= qpos, s, torch.full_like(s, NEG_INF))
    m = s.max(dim=-1, keepdim=True).values
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float()) / l.permute(0, 2, 1, 3)
    lse = (m + torch.log(l))[..., 0]
    return o.to(q.dtype), lse


# --------------------------------------------------------------- the kernel
def _lib():
    fn = build.load("flash_attention").dl4j_flash_attention_fwd
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [I, I, P, P, P, P, P, I, I, I, I, I,
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


def flash_attention_fwd(q, k, v, causal: bool = False):
    """(o, lse). CUDA tensors launch the kernel; CPU tensors take the
    plain version."""
    if not K.on_cuda(q, k, v):
        return flash_attention_plain(q, k, v, causal)
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
                    strides, _scale(D), K.stream_of(q))
    K.check_status("flash_attention_fwd", status)
    K.LAUNCHES["flash_attention_fwd"] += 1
    return o, lse


def flash_attention(q, k, v, causal: bool = False):
    """[B, T, H, D] x3 -> [B, T, H, D] (the JAX `flash_attention`
    forward; block sizes are the kernel's own 64x64 tiles)."""
    return flash_attention_fwd(q, k, v, causal)[0]
