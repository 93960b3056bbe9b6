"""Threefry words and fused inverted dropout: CUDA kernels + plain
versions, and the autograd function around dropout.

No Pallas kernel stands behind these: the JAX package draws its masks
with `jax.random.bernoulli` and `jax.random.normal`
(`deeplearning4j_tpu/nn/conf/dropout.py:63`, `nn/layers/base.py:199`,
`nn/layers/attention.py:389`, `nn/conf/weightnoise.py:86`) and XLA fuses
the draw into its consumer. The port draws the same bits
(`common/prng.py`); written as PyTorch integer ops a draw would take
about 120 elementwise launches, so the bulk words are a kernel
(`csrc/threefry.cu`; its note gives the bound, integer operations, and
the design).

- `threefry_bits(key, n, device, offset)`: the words of flat indices
  [offset, offset + n) as int64 values in [0, 2^32) (the normal draws
  of `GaussianDropout`, `GaussianNoise` and `WeightNoise` build on
  them).
- `threefry_bits_rows(keys, n)`: [S, n] words, row s under key s of
  the [S, 2] key tensor (the `vmap` of a draw over keys: every serving
  slot's sampling noise in one launch).
- `dropout(x, key, p)`: ``where(uniform(key) < p, x / p_dt, 0)`` with
  p_dt p rounded to x's dtype, differentiable. The backward is the same
  kernel on the gradient under the same key, which recomputes the mask
  (nothing is saved but the key), and is JAX's transpose: the masked
  gradient divided by p_dt.

Dispatch as in every wrapper: a CUDA tensor (or device) launches the
kernel or raises, a CPU one takes the plain version. `LAUNCHES` counts
"dropout", "threefry_bits" and "threefry_rows" where the kernels
launch.
"""

from __future__ import annotations

import ctypes

import torch

from deeplearning4j_tpu_torch import kernels as K
from deeplearning4j_tpu_torch.common import prng
from deeplearning4j_tpu_torch.kernels import build


# words a pass of the plain version on the CPU: its temporaries (the
# index words and one a rotation, 2 MB each) stay in cache and are not
# page-faulted in afresh for every draw; a 143 M-word init draws in half
# the time of one pass over the whole range (VGG19's, measured on an
# 8-core host)
CPU_CHUNK = 1 << 19


# ------------------------------------------------------------ plain versions
def threefry_bits_plain(key, n: int, device, offset: int = 0):
    """Plain version of the words kernel: the words of flat indices
    [offset, offset + n) as int64 values in [0, 2^32), each op masked to
    32 bits; on the CPU in passes of CPU_CHUNK words."""
    device = torch.device(device)
    step = CPU_CHUNK if device.type == "cpu" else max(n, 1)
    out = torch.empty(n, dtype=torch.int64, device=device)
    for a in range(0, n, step):
        b = min(n, a + step)
        idx = torch.arange(offset + a, offset + b, dtype=torch.int64,
                           device=device)
        y0, y1 = prng.threefry2x32(key[0], key[1], idx >> 32,
                                   idx & prng.MASK)
        torch.bitwise_xor(y0, y1, out=out[a:b])
    return out


def threefry_bits_rows_plain(keys: torch.Tensor, n: int) -> torch.Tensor:
    """Plain version of the per-row-key kernel on keys' device: [S, n]
    int64 words, row s hashing the indices [0, n) under key s."""
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    k = keys.to(torch.int64) & prng.MASK
    y0, y1 = prng.threefry2x32(k[:, :1], k[:, 1:], idx >> 32,
                               idx & prng.MASK)
    return y0 ^ y1


def dropout_plain(x: torch.Tensor, key, p: float) -> torch.Tensor:
    """Plain version of the dropout kernel on x's device: the words of
    x's row-major flat indices, the fp32 uniform compared with p, the
    quotient by p rounded to x's dtype (a tensor on x's device, so the
    division is a true division on the card too)."""
    w = threefry_bits_plain(key, x.numel(), x.device).reshape(x.shape)
    u = ((w >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    keep = u < torch.tensor(p, dtype=torch.float32, device=x.device)
    p_dt = torch.tensor(p, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / p_dt, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


# --------------------------------------------------------------- the kernels
def _lib():
    lib = build.load("threefry")
    if lib.dl4j_dropout.argtypes is None:
        P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        LL, F = ctypes.c_longlong, ctypes.c_float
        lib.dl4j_threefry_bits.argtypes = [U, U, ctypes.c_ulonglong, LL, P,
                                           I, P]
        lib.dl4j_threefry_bits.restype = I
        lib.dl4j_threefry_bits_rows.argtypes = [P, LL, LL, P, I, P]
        lib.dl4j_threefry_bits_rows.restype = I
        lib.dl4j_dropout.argtypes = [I, P, P, LL, U, U, F, F, I, P]
        lib.dl4j_dropout.restype = I
    return lib


def _n_sm(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def threefry_bits(key, n: int, device, offset: int = 0) -> torch.Tensor:
    """The words of flat indices [offset, offset + n) under `key`, int64
    in [0, 2^32), on `device`: the kernel on a CUDA device, the plain
    version on the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return threefry_bits_plain(key, n, device, offset)
    if device.type != "cuda":
        raise ValueError(f"threefry_bits runs on CUDA or the CPU; got "
                         f"{device}")
    out = torch.empty(n, dtype=torch.int32, device=device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
    status = _lib().dl4j_threefry_bits(int(key[0]), int(key[1]), int(offset),
                                       n, K.ptr(out), _n_sm(device), stream)
    K.check_status("threefry_bits", status)
    K.count_launch("threefry_bits", torch.int32)
    return out.to(torch.int64) & prng.MASK


def threefry_bits_rows(keys: torch.Tensor, n: int) -> torch.Tensor:
    """[S, n] words, row s under key s of `keys` ([S, 2], values in
    [0, 2^32)), int64 on keys' device: the kernel for a CUDA tensor, the
    plain version for a CPU one."""
    if not K.on_cuda(keys):
        return threefry_bits_rows_plain(keys, n)
    k = keys.to(torch.int64) & prng.MASK
    k32 = torch.where(k >= 2 ** 31, k - 2 ** 32, k).to(torch.int32)
    k32 = k32.contiguous()
    S = k32.shape[0]
    out = torch.empty((S, n), dtype=torch.int32, device=keys.device)
    status = _lib().dl4j_threefry_bits_rows(K.ptr(k32), S, int(n),
                                            K.ptr(out), _n_sm(keys.device),
                                            K.stream_of(out))
    K.check_status("threefry_rows", status)
    K.count_launch("threefry_rows", torch.int32)
    return out.to(torch.int64) & prng.MASK


def dropout_fwd(x: torch.Tensor, key, p: float) -> torch.Tensor:
    """One dropout pass: the kernel for a CUDA tensor (any layout: a
    strided view is made contiguous first), the plain version for a CPU
    one."""
    if not K.on_cuda(x):
        return dropout_plain(x, key, p)
    x = x.contiguous()
    y = torch.empty_like(x)
    p32 = float(torch.tensor(p, dtype=torch.float32))
    p_dt = float(torch.tensor(p, dtype=x.dtype))
    status = _lib().dl4j_dropout(K.dtype_code(x), K.ptr(x), K.ptr(y),
                                 x.numel(), int(key[0]), int(key[1]), p32,
                                 p_dt, _n_sm(x.device), K.stream_of(x))
    K.check_status("dropout", status)
    K.count_launch("dropout", x.dtype)
    return y


class _DropoutFn(torch.autograd.Function):
    """y = dropout(x): the kernel (or its plain version on the CPU) both
    ways; the backward recomputes the mask from the key."""

    @staticmethod
    def forward(ctx, x, k0, k1, p):
        ctx.key, ctx.p = (k0, k1), p
        return dropout_fwd(x, (k0, k1), p)

    @staticmethod
    def backward(ctx, g):
        return dropout_fwd(g, ctx.key, ctx.p), None, None, None


class _DropoutRowsFn(torch.autograd.Function):
    """Dropout of rows of a larger batch: the mask's words from the flat
    offset on (`threefry_bits`, the kernel on the card), kept for the
    backward."""

    @staticmethod
    def forward(ctx, x, k0, k1, p, offset):
        w = threefry_bits((k0, k1), x.numel(), x.device, offset)
        u = (((w >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
             - 1.0).reshape(x.shape)
        keep = u < torch.tensor(p, dtype=torch.float32, device=x.device)
        p_dt = torch.tensor(p, dtype=x.dtype, device=x.device)
        ctx.save_for_backward(keep)
        ctx.p_dt = p_dt
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        return torch.where(keep, x / p_dt, zero)

    @staticmethod
    def backward(ctx, g):
        keep, = ctx.saved_tensors
        zero = torch.zeros((), dtype=g.dtype, device=g.device)
        return torch.where(keep, g / ctx.p_dt.to(g.dtype), zero), \
            None, None, None, None


def dropout(x: torch.Tensor, key, p: float) -> torch.Tensor:
    """Inverted dropout with RETAIN probability `p` under the threefry
    `key` (JAX's ``where(bernoulli(key, p, x.shape), x / p, 0)``);
    p >= 1 returns x. Inside `common.global_batch.global_rows`, x is
    rows of the global batch and takes those rows of the global mask."""
    if p >= 1.0:
        return x
    from deeplearning4j_tpu_torch.common.global_batch import (
        row_offset_elements)
    off = row_offset_elements(x)
    if off is not None:
        return _DropoutRowsFn.apply(x, int(key[0]), int(key[1]), float(p),
                                    off)
    return _DropoutFn.apply(x, int(key[0]), int(key[1]), float(p))
