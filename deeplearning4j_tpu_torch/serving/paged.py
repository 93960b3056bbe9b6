"""Paged KV-cache pool: fixed-size blocks + host-side accounting
(counterpart of `deeplearning4j_tpu/serving/paged.py`: `blocks_needed`
:39, `BlockAllocator` :44, `PagedKVPool` :328).

K/V live in one pool of blocks `[n_blocks, block_len, H, Dh]` per
transformer block layer, in the net's compute dtype, on the net's
device. The pools are UPDATED IN PLACE by the decode and admission
paths (the JAX package threads new arrays through jit; in place saves a
pool copy per layer and dispatch).

Block id 0 is RESERVED as the garbage block: inactive slots and
block-table padding point at it, so masked scatter lanes always have a
legal target. The allocator never hands it out. Copy-on-write sharing
(refcounts, the radix prefix cache) is a later slice.
"""

from __future__ import annotations

from typing import List, Optional, Set

import torch

from deeplearning4j_tpu_torch.nn.layers.transformer import (
    TransformerEncoderBlock,
)

GARBAGE_BLOCK = 0


def blocks_needed(total_tokens: int, block_len: int) -> int:
    """Blocks a sequence of `total_tokens` (prompt + generated) owns."""
    return -(-int(total_tokens) // int(block_len))


class BlockAllocator:
    """Host-side free list over pool block ids 1..n_blocks-1 (id 0 is the
    garbage block). Allocation is all-or-nothing; LIFO reuse. Freeing a
    block that is not granted raises (double-free guard), and a batch is
    validated whole before anything is freed."""

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError(
                f"need at least 2 pool blocks (1 usable + the reserved "
                f"garbage block); got {n_blocks}")
        self.n_blocks = int(n_blocks)
        self._free: List[int] = list(range(self.n_blocks - 1, 0, -1))
        self._granted: Set[int] = set()

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return (self.n_blocks - 1) - len(self._free)

    def allocate(self, n: int) -> Optional[List[int]]:
        """`n` block ids, or None if the pool can't cover them now."""
        if n <= 0:
            raise ValueError(f"allocate(n={n})")
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        self._granted.update(out)
        return out

    def free(self, blocks: List[int]):
        seen = set()
        for b in blocks:
            b = int(b)
            if not 0 < b < self.n_blocks:
                raise ValueError(f"freeing invalid block id {b}")
            if b not in self._granted or b in seen:
                raise ValueError(f"double-free of block {b}")
            seen.add(b)
        for b in blocks:
            self._granted.discard(int(b))
            self._free.append(int(b))


class PagedKVPool:
    """The per-layer block pools for one net + the shared allocator.
    `kv` is a list of (k_pool, v_pool) pairs, one per
    TransformerEncoderBlock in layer order."""

    def __init__(self, net, n_blocks: int, block_len: int):
        if block_len < 1:
            raise ValueError(f"block_len must be >= 1; got {block_len}")
        self.block_len = int(block_len)
        self.n_blocks = int(n_blocks)
        self.layer_indices = [i for i, l in enumerate(net.layers)
                              if isinstance(l, TransformerEncoderBlock)]
        if not self.layer_indices:
            raise ValueError("PagedKVPool needs at least one "
                             "TransformerEncoderBlock layer")
        self.kv = []
        for i in self.layer_indices:
            layer = net.layers[i]
            shape = (self.n_blocks, self.block_len, layer.n_heads,
                     layer.n_in // layer.n_heads)
            self.kv.append(tuple(
                torch.zeros(shape, dtype=net.dtype.compute_dtype,
                            device=net.device) for _ in range(2)))
        self.allocator = BlockAllocator(self.n_blocks)

    @property
    def free_blocks(self) -> int:
        return self.allocator.free_blocks
