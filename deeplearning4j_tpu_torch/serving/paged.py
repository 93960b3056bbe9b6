"""Paged KV-cache pool: fixed-size blocks + host-side accounting
(counterpart of `deeplearning4j_tpu/serving/paged.py`: `blocks_needed`
:39, `BlockAllocator` :44, `_RadixNode` :136, `RadixPrefixCache` :159,
`PagedKVPool` :328).

K/V live in one pool of blocks `[n_blocks, block_len, H, Dh]` per
transformer block layer, in the net's compute dtype, on the net's
device. The pools are UPDATED IN PLACE by the decode and admission
paths (the JAX package threads new arrays through jit; in place saves a
pool copy per layer and dispatch).

Block id 0 is RESERVED as the garbage block: inactive slots and
block-table padding point at it, so masked scatter lanes always have a
legal target. The allocator never hands it out. Its grants are
refcounted, so a registered prefix, the radix prefix cache and the
slots that ride them map the same physical blocks copy-on-write.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

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
    garbage block). Allocation is all-or-nothing; LIFO reuse. Grants are
    refcounted for copy-on-write sharing: `allocate` hands out blocks at
    refcount 1, `share` takes one more reference on granted blocks (a
    slot or the prefix cache mapping the same physical block), and
    `free` drops one reference, returning a block to the free list when
    its last holder lets go. Sharing a free block, and dropping a
    reference a block does not carry (a double free), raise; a batch is
    validated whole before anything changes."""

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError(
                f"need at least 2 pool blocks (1 usable + the reserved "
                f"garbage block); got {n_blocks}")
        self.n_blocks = int(n_blocks)
        self._free: List[int] = list(range(self.n_blocks - 1, 0, -1))
        self._refs: Dict[int, int] = {}      # granted block -> refcount

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return (self.n_blocks - 1) - len(self._free)

    @property
    def shared_blocks(self) -> int:
        """Blocks mapped by more than one holder (refcount > 1)."""
        return sum(1 for r in self._refs.values() if r > 1)

    def refcount(self, block: int) -> int:
        return self._refs.get(int(block), 0)

    def allocate(self, n: int) -> Optional[List[int]]:
        """`n` block ids at refcount 1, or None if the pool can't cover
        them now."""
        if n <= 0:
            raise ValueError(f"allocate(n={n})")
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._refs[b] = 1
        return out

    def share(self, blocks: List[int]):
        """One more reference on each of `blocks`, which must be granted
        (a share of a free block would alias its next owner)."""
        for b in blocks:
            b = int(b)
            if self._refs.get(b, 0) < 1:
                raise ValueError(
                    f"share of block {b} which is not granted (free or "
                    f"out of range) — a stale grant reference")
        for b in blocks:
            self._refs[int(b)] += 1

    def free(self, blocks: List[int]):
        need: Dict[int, int] = {}
        for b in blocks:
            b = int(b)
            if not 0 < b < self.n_blocks:
                raise ValueError(f"freeing invalid block id {b}")
            need[b] = need.get(b, 0) + 1
        for b, n in need.items():
            if self._refs.get(b, 0) < n:
                raise ValueError(f"double-free of block {b}")
        for b in blocks:
            b = int(b)
            self._refs[b] -= 1
            if self._refs[b] == 0:
                del self._refs[b]
                self._free.append(b)


class _RadixNode:
    """One edge of the radix tree: a run of block-aligned token chunks
    (`tokens`, a multiple of block_len long) and the pool blocks holding
    their K/V (`blocks[j]` holds `tokens[j*bl:(j+1)*bl]`). Children are
    keyed by their first block's token tuple."""

    __slots__ = ("tokens", "blocks", "children", "parent", "last_used",
                 "pinned")

    def __init__(self, tokens, blocks, parent):
        self.tokens = tokens
        self.blocks = blocks
        self.children: Dict[tuple, "_RadixNode"] = {}
        self.parent = parent
        self.last_used = 0
        self.pinned = False


class RadixPrefixCache:
    """Radix tree over block-aligned token chunks: automatic prefix
    dedup across all admissions (`prefix_cache="radix"`). An admission's
    prompt is `match()`ed (the longest block-aligned cached prefix; the
    engine shares those blocks into the slot) and `insert()`ed after
    (its full prompt blocks become edges, the cache holding its own
    reference on each, so a finished slot leaves the prefix resident).
    `evict_lru()` drops the least-recently-used unpinned leaf; a block a
    live slot still maps survives at the slot's refcount. Nothing here
    is pinned capacity."""

    def __init__(self, allocator: BlockAllocator, block_len: int):
        self.alloc = allocator
        self.block_len = int(block_len)
        self.root = _RadixNode((), [], None)
        self._n_nodes = 0
        self._clock = 0

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    @property
    def nodes(self) -> int:
        """Edge count (root excluded)."""
        return self._n_nodes

    def _iter_nodes(self):
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            yield n

    @property
    def held_blocks(self) -> int:
        return sum(len(n.blocks) for n in self._iter_nodes())

    @property
    def evictable_blocks(self) -> int:
        """Blocks that evicting the whole unpinned tree would return to
        the free list (the cache is their only holder)."""
        return sum(1 for n in self._iter_nodes() if not n.pinned
                   for b in n.blocks if self.alloc.refcount(b) == 1)

    def match(self, tokens) -> Tuple[int, List[int]]:
        """(matched tokens, blocks) of the longest block-aligned cached
        prefix of `tokens`; touches the path for LRU."""
        t = tuple(int(x) for x in tokens)
        bl = self.block_len
        now = self._tick()
        node, i, out = self.root, 0, []
        while len(t) - i >= bl:
            child = node.children.get(t[i:i + bl])
            if child is None:
                break
            m = 0
            while (m < len(child.blocks) and i + (m + 1) * bl <= len(t)
                   and child.tokens[m * bl:(m + 1) * bl]
                   == t[i + m * bl:i + (m + 1) * bl]):
                m += 1
            child.last_used = now
            out.extend(child.blocks[:m])
            i += m * bl
            if m < len(child.blocks):
                break
            node = child
        return i, out

    def insert(self, tokens, blocks) -> int:
        """Insert the full prompt blocks of a just-admitted slot
        (`tokens[:len(blocks) * block_len]` are what they hold). Parts
        already cached are skipped; the diverging rest becomes a new
        edge the cache takes its own references on. Returns the number
        of newly referenced blocks."""
        bl = self.block_len
        t = tuple(int(x) for x in tokens)
        nb = min(len(t) // bl, len(blocks))
        t = t[:nb * bl]
        now = self._tick()
        node, i, bi = self.root, 0, 0
        while bi < nb:
            key = t[i:i + bl]
            child = node.children.get(key)
            if child is None:
                new_blocks = [int(b) for b in blocks[bi:nb]]
                self.alloc.share(new_blocks)
                leaf = _RadixNode(t[i:], new_blocks, node)
                leaf.last_used = now
                node.children[key] = leaf
                self._n_nodes += 1
                return len(new_blocks)
            m = 0
            while (m < len(child.blocks) and bi + m < nb
                   and child.tokens[m * bl:(m + 1) * bl]
                   == t[i + m * bl:i + (m + 1) * bl]):
                m += 1
            child.last_used = now
            if m == len(child.blocks):
                node, i, bi = child, i + m * bl, bi + m
                continue
            if bi + m == nb:
                return 0          # the prompt ends inside the edge
            node = self._split(child, m)
            i, bi = i + m * bl, bi + m
        return 0

    def _split(self, child: "_RadixNode", m: int) -> "_RadixNode":
        """Split `child` at block boundary m (0 < m < its blocks): the
        upper part becomes a new interior node, `child` keeps the
        tail."""
        bl = self.block_len
        parent = child.parent
        upper = _RadixNode(child.tokens[:m * bl], child.blocks[:m], parent)
        upper.last_used = child.last_used
        upper.pinned = child.pinned
        parent.children[child.tokens[:bl]] = upper
        child.tokens = child.tokens[m * bl:]
        child.blocks = child.blocks[m:]
        child.parent = upper
        upper.children[child.tokens[:bl]] = child
        self._n_nodes += 1
        return upper

    def evict_lru(self) -> int:
        """Drop the cache's references on the least-recently-used
        unpinned leaf; returns how many (0: nothing evictable)."""
        best = None
        for n in self._iter_nodes():
            if n.children or n.pinned:
                continue
            if best is None or n.last_used < best.last_used:
                best = n
        if best is None:
            return 0
        del best.parent.children[best.tokens[:self.block_len]]
        self.alloc.free(best.blocks)
        self._n_nodes -= 1
        return len(best.blocks)

    def clear(self) -> int:
        """Release every reference the cache holds."""
        dropped = 0
        for n in list(self._iter_nodes()):
            self.alloc.free(n.blocks)
            dropped += len(n.blocks)
        self.root.children.clear()
        self._n_nodes = 0
        return dropped


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

    @property
    def used_blocks(self) -> int:
        return self.allocator.used_blocks

    def device_bytes(self) -> int:
        """Device bytes of every layer's K and V pool."""
        return sum(t.numel() * t.element_size() for kv in self.kv for t in kv)
