"""QuadTree for 2-D Barnes-Hut (reference `clustering/quadtree/
QuadTree.java`): 4-way spatial subdivision with center-of-mass
aggregation; used by 2-D t-SNE. Counterpart of
`deeplearning4j_tpu/clustering/quadtree.py`: host numpy, no device."""

from __future__ import annotations

from typing import Optional

import numpy as np


class QuadTree:
    MAX_DEPTH = 50

    def __init__(self, center_x: float, center_y: float,
                 half_w: float, half_h: float, depth: int = 0):
        self.cx, self.cy = center_x, center_y
        self.hw, self.hh = half_w, half_h
        self.depth = depth
        self.size = 0
        self.com = np.zeros(2)          # center of mass
        self.point: Optional[np.ndarray] = None
        self.index = -1
        self.children = None

    @staticmethod
    def build(points: np.ndarray) -> "QuadTree":
        points = np.asarray(points, np.float64)
        lo = points.min(axis=0)
        hi = points.max(axis=0)
        c = (lo + hi) / 2
        half = np.maximum((hi - lo) / 2, 1e-5) * 1.001
        tree = QuadTree(c[0], c[1], half[0], half[1])
        for i, p in enumerate(points):
            tree.insert(p, i)
        return tree

    def contains(self, p) -> bool:
        return (abs(p[0] - self.cx) <= self.hw + 1e-12
                and abs(p[1] - self.cy) <= self.hh + 1e-12)

    def _subdivide(self):
        hw, hh = self.hw / 2, self.hh / 2
        self.children = [
            QuadTree(self.cx - hw, self.cy - hh, hw, hh, self.depth + 1),
            QuadTree(self.cx + hw, self.cy - hh, hw, hh, self.depth + 1),
            QuadTree(self.cx - hw, self.cy + hh, hw, hh, self.depth + 1),
            QuadTree(self.cx + hw, self.cy + hh, hw, hh, self.depth + 1),
        ]

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
                self._child_for(old).insert(old, oi)
        self._child_for(p).insert(p, index)

    def _child_for(self, p):
        i = (1 if p[0] > self.cx else 0) + (2 if p[1] > self.cy else 0)
        return self.children[i]

    def compute_non_edge_forces(self, point, theta: float, neg_f: np.ndarray) -> float:
        """Barnes-Hut negative-force accumulation for t-SNE gradient;
        returns the sum contribution to Z."""
        if self.size == 0:
            return 0.0
        diff = point - self.com
        d2 = float(diff @ diff)
        max_width = max(self.hw, self.hh) * 2
        if self.children is None or max_width * max_width / max(d2, 1e-12) < theta * theta:
            if self.point is not None and np.allclose(self.com, point):
                return 0.0
            q = 1.0 / (1.0 + d2)
            mult = self.size * q
            neg_f += mult * q * diff
            return mult
        return sum(c.compute_non_edge_forces(point, theta, neg_f)
                   for c in self.children)
