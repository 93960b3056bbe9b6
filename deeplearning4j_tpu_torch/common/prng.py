"""Threefry-2x32 keys and draws, bit for bit as `jax.random` makes them
(JAX 0.9 with `jax_threefry_partitionable=True`, the JAX package's
setting), so the port draws the same dropout and weight-noise masks as
the JAX package from the same seed.

The JAX package has no module of its own for this: it calls
`jax.random.PRNGKey`, `fold_in`, `bernoulli`, `uniform` and `normal`
(`nn/multilayer.py:245,698`, `nn/scan_stack.py:63,346`,
`nn/conf/dropout.py`, `nn/conf/weightnoise.py`). What they compute:

- a key is two uint32 words; `key(seed)` is ``(0, seed & 0xFFFFFFFF)``
  for the 32-bit seeds the containers use (`PRNGKey` keeps the high
  word of a 64-bit seed, which a 32-bit seed does not have);
- `fold_in(key, d)` is the threefry hash of the pair ``(0, d)`` under
  `key`;
- `bits(key, shape)`: element n of the row-major flattening hashes the
  pair ``(n >> 32, n & 0xFFFFFFFF)`` and returns ``x0 ^ x1``;
- `uniform` keeps the top 23 bits as the mantissa of a float in
  [1, 2) and subtracts 1 (bf16: the low 8 bits, top 7 as the
  mantissa); `bernoulli(key, p)` is ``uniform < float32(p)``;
- `normal` is ``sqrt(2) * erfinv(u)`` with u uniform on
  ``[nextafter(-1, 0), 1)`` in the draw's dtype (XLA's erfinv and
  torch's agree to about 4e-6 relative; the bits are exact).

Keys live on the host as two Python ints, so deriving one (a fold per
step, layer and param) costs no device work. Only `bits` and the draws
built on it touch tensors: on a CUDA device `bits` is the
`dl4j_threefry_bits` kernel (`kernels/dropout.py`); on the CPU its plain
version (`kernels.dropout.threefry_bits_plain`), in int64 with
``& 0xFFFFFFFF``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import math

import torch

Key = Tuple[int, int]

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds, JAX's
    `_threefry2x32_lowering`) of the words (x0, x1) under the key
    (k0, k1). Works on Python ints and on int64 tensors whose values lie
    in [0, 2^32); returns the pair (y0, y1)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << r) & MASK) | (x1 >> (32 - r))
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def key(seed: int) -> Key:
    """`jax.random.PRNGKey(seed)` for a 32-bit seed."""
    return (0, int(seed) & MASK)


def fold_in(k: Key, data: int) -> Key:
    """`jax.random.fold_in(k, data)`."""
    return threefry2x32(k[0], k[1], 0, int(data) & MASK)


def _numel(shape) -> int:
    return math.prod(int(s) for s in shape)


def bits(k: Key, shape: Sequence[int], device="cpu") -> torch.Tensor:
    """`jax.random.bits(k, shape)` (uint32) as int64 values in
    [0, 2^32): the kernel on a CUDA device, the plain version on the
    CPU."""
    from deeplearning4j_tpu_torch.kernels.dropout import threefry_bits
    return threefry_bits(k, _numel(shape), torch.device(device)).reshape(
        tuple(shape))


def _float_from_bits(b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[1, 2) floats whose mantissa comes from the top bits of the
    word: float32 takes bits 31..9, bf16 the low byte's top 7 bits
    (JAX draws 8-bit words for a 7-bit mantissa)."""
    if dtype == torch.float32:
        return ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    if dtype == torch.bfloat16:
        return (((b & 0xFF) >> 1) | 0x3F80).to(torch.int16).view(
            torch.bfloat16)
    raise TypeError(f"draws are float32 or bfloat16; got {dtype}")


def uniform(k: Key, shape, dtype=torch.float32, minval=0.0, maxval=1.0,
            device="cpu") -> torch.Tensor:
    """`jax.random.uniform(k, shape, dtype, minval, maxval)`: the bounds
    rounded to `dtype`, ``u * (hi - lo) + lo`` rounded once (XLA fuses it
    into a multiply-add; float64 holds the product exactly), then
    clipped below at lo."""
    f = _float_from_bits(bits(k, shape, device), dtype) - 1.0
    lo = torch.tensor(minval, dtype=dtype, device=f.device)
    hi = torch.tensor(maxval, dtype=dtype, device=f.device)
    scaled = f.double() * (hi - lo).double() + lo.double()
    return torch.maximum(lo, scaled.to(dtype))


def bernoulli(k: Key, p: float, shape, device="cpu") -> torch.Tensor:
    """`jax.random.bernoulli(k, p, shape)` for a Python float p: a bool
    tensor, True where ``uniform < float32(p)``."""
    return uniform(k, shape, torch.float32, device=device) < torch.tensor(
        p, dtype=torch.float32)


# nextafter(-1, 0) in each draw dtype: -(1 - 2^-24), -(1 - 2^-8)
_NEXT_AFTER_MINUS_ONE = {torch.float32: -(1.0 - 2.0 ** -24),
                         torch.bfloat16: -(1.0 - 2.0 ** -8)}


def normal(k: Key, shape, dtype=torch.float32, device="cpu"):
    """`jax.random.normal(k, shape, dtype)`: ``sqrt(2) * erfinv(u)``,
    u uniform on [nextafter(-1, 0), 1). The erfinv is computed in
    float32 and rounded to `dtype`."""
    lo = _NEXT_AFTER_MINUS_ONE[dtype]
    u = uniform(k, shape, dtype, lo, 1.0, device)
    e = torch.erfinv(u.float()).to(dtype)
    return e * torch.tensor(math.sqrt(2.0), dtype=dtype)
