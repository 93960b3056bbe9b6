"""Vantage-point tree for metric-space kNN.
Counterpart of `deeplearning4j_tpu/clustering/vptree.py`: host numpy, no
device.

Reference: `clustering/vptree/VPTree.java` (parallel build, euclidean
default). Build: pick a vantage point, split remaining points at the
median distance; search prunes by the triangle inequality. Distances
over candidate leaves are computed with vectorised numpy (the
reference's parallel scalar loops → SIMD batch ops).
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np


class _Node:
    __slots__ = ("index", "threshold", "inside", "outside")

    def __init__(self, index, threshold=0.0, inside=None, outside=None):
        self.index = index
        self.threshold = threshold
        self.inside = inside
        self.outside = outside


class VPTree:
    def __init__(self, points: np.ndarray, distance: str = "euclidean",
                 leaf_size: int = 32, seed: int = 0):
        self.items = np.asarray(points, np.float64)
        self.distance = distance
        self.leaf_size = leaf_size
        self._rng = np.random.default_rng(seed)
        idx = np.arange(len(self.items))
        self.root = self._build(idx)

    # ------------------------------------------------------------ metric
    def _dist(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        if self.distance == "euclidean":
            return np.sqrt(np.sum((a - b) ** 2, axis=-1))
        if self.distance == "manhattan":
            return np.sum(np.abs(a - b), axis=-1)
        if self.distance == "cosine":
            na = np.linalg.norm(a, axis=-1)
            nb = np.linalg.norm(b, axis=-1)
            return 1.0 - np.sum(a * b, axis=-1) / np.clip(na * nb, 1e-12, None)
        raise ValueError(self.distance)

    # ------------------------------------------------------------- build
    def _build(self, idx: np.ndarray):
        if len(idx) == 0:
            return None
        if len(idx) <= self.leaf_size:
            return ("leaf", idx)
        vp_pos = int(self._rng.integers(len(idx)))
        vp = idx[vp_pos]
        rest = np.delete(idx, vp_pos)
        d = self._dist(self.items[rest], self.items[vp][None, :])
        med = float(np.median(d))
        inside = rest[d <= med]
        outside = rest[d > med]
        if len(inside) == 0 or len(outside) == 0:  # degenerate split
            return ("leaf", idx)
        node = _Node(vp, med)
        node.inside = self._build(inside)
        node.outside = self._build(outside)
        return node

    # ------------------------------------------------------------ search
    def knn(self, query, k: int) -> Tuple[List[int], List[float]]:
        """Returns (indices, distances) of the k nearest points."""
        query = np.asarray(query, np.float64)
        heap: List[Tuple[float, int]] = []  # max-heap via negated distance
        tau = [np.inf]

        def consider(indices):
            d = self._dist(self.items[indices], query[None, :])
            for di, ii in zip(d, indices):
                if len(heap) < k:
                    heapq.heappush(heap, (-di, int(ii)))
                    if len(heap) == k:
                        tau[0] = -heap[0][0]
                elif di < tau[0]:
                    heapq.heapreplace(heap, (-di, int(ii)))
                    tau[0] = -heap[0][0]

        def search(node):
            if node is None:
                return
            if isinstance(node, tuple):  # leaf
                consider(node[1])
                return
            d = float(self._dist(self.items[node.index][None, :], query[None, :])[0])
            consider(np.array([node.index]))
            if d <= node.threshold:
                search(node.inside)
                if d + tau[0] > node.threshold:
                    search(node.outside)
            else:
                search(node.outside)
                if d - tau[0] <= node.threshold:
                    search(node.inside)

        search(self.root)
        pairs = sorted(((-nd, i) for nd, i in heap))
        return [i for _, i in pairs], [d for d, _ in pairs]
