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
  torch's agree to about 4e-6 relative; the bits are exact);
- `split(key, n)` hashes the counters ``(0, i)``, i < n, under the key
  (the partitionable layout), so ``split(key, n)[i] == fold_in(key,
  i)``;
- `truncated_normal` is ``sqrt(2) * erfinv(u)`` with u uniform on
  ``[erf(lower / sqrt 2), erf(upper / sqrt 2))``, clipped into the open
  interval (`nextafter` of each bound);
- `gumbel` is ``-log(-log(u))`` with u uniform on ``[tiny, 1)`` (JAX's
  default "low" mode), and `categorical(key, logits)` is
  ``argmax(gumbel(key, logits.shape) + logits)``.

Keys live on the host as two Python ints, so deriving one (a fold per
step, layer and param) costs no device work. Only `bits` and the draws
built on it touch tensors: on a CUDA device `bits` is the
`dl4j_threefry_bits` kernel (`kernels/dropout.py`); on the CPU its plain
version (`kernels.dropout.threefry_bits_plain`), in int32 with
wrapping adds and masked right shifts (int64 with ``& 0xFFFFFFFF`` where
the keys are tensors). `row_bits(keys, n)` hashes row s of a draw under key
s of a [S, 2] key tensor (JAX's `vmap` of a draw over keys), one launch
of `dl4j_threefry_bits_rows` for every row; the `*_rows` draws build on
it.
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
    if isinstance(x0, torch.Tensor) and isinstance(k0, int) \
            and isinstance(k1, int):
        return _threefry2x32_int32(k0, k1, x0, x1)
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


def _s32(v: int) -> int:
    """The int32 with the bits of the 32-bit word `v`."""
    v &= MASK
    return v - (1 << 32) if v >= 1 << 31 else v


def _threefry2x32_int32(k0: int, k1: int, x0, x1):
    """`threefry2x32` of tensor words under an int key, in int32 with
    in-place ops: adds wrap modulo 2^32 and a right shift is made
    logical by masking, so each word holds the same 32 bits in half the
    int64 version's bytes, with one temporary a rotation (about 8x
    faster on the CPU). Returns int64 values in [0, 2^32), as the
    generic path."""
    ks = (_s32(k0), _s32(k1), _s32(k0 ^ k1 ^ _PARITY))
    x0 = x0.to(torch.int32).add_(ks[0])
    x1 = x1.to(torch.int32).add_(ks[1])
    for i in range(5):
        for r in _ROT[i % 2]:
            x0.add_(x1)
            high = x1 << r
            x1.bitwise_right_shift_(32 - r).bitwise_and_((1 << r) - 1)
            x1.bitwise_or_(high).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3])
        x1.add_(_s32(ks[(i + 2) % 3] + i + 1))
    return x0.to(torch.int64) & MASK, x1.to(torch.int64) & MASK


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
    return _uniform_from(bits(k, shape, device), dtype, minval, maxval)


def bernoulli(k: Key, p, shape=None, device="cpu") -> torch.Tensor:
    """`jax.random.bernoulli(k, p, shape)`: a bool tensor, True where
    ``uniform < p``. A Python float p compares as float32 over `shape`;
    a tensor p (RBM's per-unit means) draws its own shape in its own
    dtype on its own device, as JAX's ``uniform(k, p.shape, p.dtype) <
    p``."""
    if isinstance(p, torch.Tensor):
        return uniform(k, p.shape, p.dtype, device=p.device) < p
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


def split(k: Key, n: int = 2):
    """`jax.random.split(k, n)` as a list of n keys."""
    return [fold_in(k, i) for i in range(int(n))]


def keys_tensor(keys, device="cpu") -> torch.Tensor:
    """A [S, 2] int64 tensor of keys (values in [0, 2^32))."""
    return torch.tensor([[int(a) & MASK, int(b) & MASK] for a, b in keys],
                        dtype=torch.int64, device=device).reshape(-1, 2)


def fold_in_rows(keys: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """`vmap(fold_in)(keys, data)`: [S, 2] keys and [S] int data (on any
    device) to [S, 2] keys, as int64 tensor ops."""
    y0, y1 = threefry2x32(keys[:, 0], keys[:, 1],
                          torch.zeros_like(data, dtype=torch.int64),
                          data.to(torch.int64) & MASK)
    return torch.stack([y0, y1], dim=1)


def row_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """`vmap(lambda k: bits(k, (n,)))(keys)`: [S, n] words, row s under
    key s of the [S, 2] `keys`, on keys' device."""
    from deeplearning4j_tpu_torch.kernels.dropout import threefry_bits_rows
    return threefry_bits_rows(keys, int(n))


def _uniform_from(b: torch.Tensor, dtype, minval, maxval):
    f = _float_from_bits(b, dtype) - 1.0
    lo = torch.as_tensor(minval, dtype=dtype, device=f.device)
    hi = torch.as_tensor(maxval, dtype=dtype, device=f.device)
    scaled = f.double() * (hi - lo).double() + lo.double()
    return torch.maximum(lo, scaled.to(dtype))


_TINY = {torch.float32: torch.finfo(torch.float32).tiny,
         torch.bfloat16: torch.finfo(torch.bfloat16).tiny}


def _gumbel_from(b: torch.Tensor, dtype) -> torch.Tensor:
    u = _uniform_from(b, dtype, _TINY[dtype], 1.0)
    return -torch.log(-torch.log(u))


def gumbel(k: Key, shape, dtype=torch.float32, device="cpu"):
    """`jax.random.gumbel(k, shape, dtype)` (mode "low"):
    ``-log(-log(uniform(k, shape, dtype, tiny, 1)))``."""
    return _gumbel_from(bits(k, shape, device), dtype)


def categorical(k: Key, logits: torch.Tensor, axis: int = -1):
    """`jax.random.categorical(k, logits, axis)`: the argmax over `axis`
    of ``logits + gumbel(k, logits.shape)``, the noise in the logits'
    dtype."""
    g = gumbel(k, logits.shape, logits.dtype, logits.device)
    return torch.argmax(logits + g, dim=axis)


def uniform_rows(keys: torch.Tensor, n: int, dtype=torch.float32,
                 minval=0.0, maxval=1.0) -> torch.Tensor:
    """`vmap(lambda k: uniform(k, (n,), dtype, minval, maxval))(keys)`:
    [S, n]."""
    return _uniform_from(row_bits(keys, n), dtype, minval, maxval)


def gumbel_rows(keys: torch.Tensor, n: int, dtype=torch.float32):
    """`vmap(lambda k: gumbel(k, (n,), dtype))(keys)`: [S, n], every
    row's words from one launch."""
    return _gumbel_from(row_bits(keys, n), dtype)


def categorical_rows(keys: torch.Tensor, logits: torch.Tensor):
    """`vmap(categorical)(keys, logits)`: row s of `logits` [S, V] drawn
    under key s of `keys` [S, 2], all rows' noise from one launch."""
    g = gumbel_rows(keys, logits.shape[-1], logits.dtype)
    return torch.argmax(logits + g, dim=-1)


def truncated_normal(k: Key, lower: float, upper: float, shape,
                     dtype=torch.float32, device="cpu") -> torch.Tensor:
    """`jax.random.truncated_normal(k, lower, upper, shape, dtype)`: the
    bounds in `dtype`, u uniform on [erf(lower / sqrt 2), erf(upper /
    sqrt 2)), ``sqrt(2) * erfinv(u)`` clipped to the open interval."""
    sqrt2 = torch.tensor(math.sqrt(2.0), dtype=dtype)
    lo = torch.tensor(lower, dtype=dtype)
    hi = torch.tensor(upper, dtype=dtype)
    a = torch.erf((lo / sqrt2).float()).to(dtype)
    b = torch.erf((hi / sqrt2).float()).to(dtype)
    u = uniform(k, shape, dtype, a, b, device)
    out = sqrt2.to(u.device) * torch.erfinv(u.float()).to(dtype)
    inf = torch.tensor(float("inf"), dtype=dtype)
    return out.clamp(float(torch.nextafter(lo, inf)),
                     float(torch.nextafter(hi, -inf)))
