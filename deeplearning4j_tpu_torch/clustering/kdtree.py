"""KD-tree (reference `clustering/kdtree/KDTree.java`): axis-cycled
median build, kNN + range queries with hyperplane pruning. Counterpart
of `deeplearning4j_tpu/clustering/kdtree.py`: host numpy, no device."""

from __future__ import annotations

import heapq
from typing import List, Tuple

import numpy as np


class _KDNode:
    __slots__ = ("index", "axis", "left", "right")

    def __init__(self, index, axis):
        self.index = index
        self.axis = axis
        self.left = None
        self.right = None


class KDTree:
    def __init__(self, points: np.ndarray):
        self.items = np.asarray(points, np.float64)
        self.dims = self.items.shape[1]
        self.root = self._build(np.arange(len(self.items)), 0)

    def _build(self, idx: np.ndarray, depth: int):
        if len(idx) == 0:
            return None
        axis = depth % self.dims
        order = np.argsort(self.items[idx, axis])
        mid = len(idx) // 2
        node = _KDNode(int(idx[order[mid]]), axis)
        node.left = self._build(idx[order[:mid]], depth + 1)
        node.right = self._build(idx[order[mid + 1:]], depth + 1)
        return node

    def knn(self, query, k: int) -> Tuple[List[int], List[float]]:
        query = np.asarray(query, np.float64)
        heap: List[Tuple[float, int]] = []

        def search(node):
            if node is None:
                return
            p = self.items[node.index]
            d = float(np.sqrt(np.sum((p - query) ** 2)))
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.index))
            elif d < -heap[0][0]:
                heapq.heapreplace(heap, (-d, node.index))
            diff = query[node.axis] - p[node.axis]
            near, far = (node.left, node.right) if diff <= 0 else (node.right, node.left)
            search(near)
            if len(heap) < k or abs(diff) < -heap[0][0]:
                search(far)

        search(self.root)
        pairs = sorted(((-nd, i) for nd, i in heap))
        return [i for _, i in pairs], [d for d, _ in pairs]

    def range(self, lower, upper) -> List[int]:
        """All points inside the axis-aligned box [lower, upper]
        (reference KDTree range query)."""
        lower = np.asarray(lower, np.float64)
        upper = np.asarray(upper, np.float64)
        out: List[int] = []

        def search(node):
            if node is None:
                return
            p = self.items[node.index]
            if np.all(p >= lower) and np.all(p <= upper):
                out.append(node.index)
            if p[node.axis] >= lower[node.axis]:
                search(node.left)
            if p[node.axis] <= upper[node.axis]:
                search(node.right)

        search(self.root)
        return out
