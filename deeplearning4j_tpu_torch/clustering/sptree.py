"""SpTree — k-dimensional Barnes-Hut tree (reference
`clustering/sptree/SpTree.java`, the dual-tree used by BarnesHutTsne):
2^d-way subdivision with center-of-mass aggregation and the same
non-edge-force accumulation as QuadTree, for arbitrary embedding dim.
Counterpart of `deeplearning4j_tpu/clustering/sptree.py`: host numpy,
no device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class SpTree:
    MAX_DEPTH = 50

    def __init__(self, center: np.ndarray, half: np.ndarray, depth: int = 0):
        self.center = np.asarray(center, np.float64)
        self.half = np.asarray(half, np.float64)
        self.d = len(center)
        self.depth = depth
        self.size = 0
        self.com = np.zeros(self.d)
        self.point: Optional[np.ndarray] = None
        self.index = -1
        self.children = None

    @staticmethod
    def build(points: np.ndarray) -> "SpTree":
        points = np.asarray(points, np.float64)
        lo, hi = points.min(axis=0), points.max(axis=0)
        center = (lo + hi) / 2
        half = np.maximum((hi - lo) / 2, 1e-5) * 1.001
        tree = SpTree(center, half)
        for i, p in enumerate(points):
            tree.insert(p, i)
        return tree

    def _child_index(self, p) -> int:
        i = 0
        for ax in range(self.d):
            if p[ax] > self.center[ax]:
                i |= (1 << ax)
        return i

    def _subdivide(self):
        self.children = []
        half = self.half / 2
        for ci in range(1 << self.d):
            offset = np.array([half[ax] if (ci >> ax) & 1 else -half[ax]
                               for ax in range(self.d)])
            self.children.append(SpTree(self.center + offset, half,
                                        self.depth + 1))

    def insert(self, p, index: int):
        p = np.asarray(p, np.float64)
        self.com = (self.com * self.size + p) / (self.size + 1)
        self.size += 1
        if self.size == 1 or self.depth >= self.MAX_DEPTH:
            if self.point is None:
                self.point = p
                self.index = index
            return
        if self.children is None:
            self._subdivide()
            old, oi = self.point, self.index
            self.point, self.index = None, -1
            if old is not None:
                self.children[self._child_index(old)].insert(old, oi)
        self.children[self._child_index(p)].insert(p, index)

    def compute_non_edge_forces(self, point, theta: float, neg_f: np.ndarray) -> float:
        if self.size == 0:
            return 0.0
        diff = point - self.com
        d2 = float(diff @ diff)
        max_width = float(np.max(self.half)) * 2
        if self.children is None or max_width * max_width / max(d2, 1e-12) < theta * theta:
            if self.point is not None and np.allclose(self.com, point):
                return 0.0
            q = 1.0 / (1.0 + d2)
            mult = self.size * q
            neg_f += mult * q * diff
            return mult
        return sum(c.compute_non_edge_forces(point, theta, neg_f)
                   for c in self.children)
