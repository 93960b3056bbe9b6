"""Random-walk iterators over graphs.

Reference: `graph/iterator/RandomWalkIterator.java`,
`WeightedRandomWalkIterator.java`, `graph/api/NoEdgeHandling.java`
(SELF_LOOP_ON_DISCONNECTED vs EXCEPTION_ON_DISCONNECTED).

The port's own copy of `deeplearning4j_tpu/graph/walkers.py`,
host code unchanged (the port imports nothing of the JAX package).
"""

from __future__ import annotations

from enum import Enum
from typing import List

import numpy as np

from deeplearning4j_tpu_torch.graph.graph import Graph


class NoEdgeHandling(str, Enum):
    SELF_LOOP_ON_DISCONNECTED = "self_loop"
    EXCEPTION_ON_DISCONNECTED = "exception"


class RandomWalkIterator:
    """Uniform random walks, one starting at each vertex per epoch."""

    def __init__(self, graph: Graph, walk_length: int, seed: int = 0,
                 no_edge_handling: NoEdgeHandling =
                 NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED):
        self.graph = graph
        self.walk_length = walk_length
        self.no_edge_handling = NoEdgeHandling(no_edge_handling)
        self.seed = seed
        self.reset()

    def reset(self):
        self._rng = np.random.default_rng(self.seed)
        self._order = self._rng.permutation(self.graph.num_vertices())
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < len(self._order)

    def _step(self, current: int) -> int:
        neighbors = self.graph.get_connected_vertices(current)
        if not neighbors:
            if self.no_edge_handling == NoEdgeHandling.EXCEPTION_ON_DISCONNECTED:
                raise ValueError(f"Vertex {current} has no edges")
            return current  # self loop
        return neighbors[int(self._rng.integers(len(neighbors)))]

    def next(self) -> List[int]:
        start = int(self._order[self._pos])
        self._pos += 1
        walk = [start]
        current = start
        for _ in range(self.walk_length - 1):
            current = self._step(current)
            walk.append(current)
        return walk

    def __iter__(self):
        self.reset()
        while self.has_next():
            yield self.next()


class WeightedRandomWalkIterator(RandomWalkIterator):
    """Transition probability ∝ edge weight (reference
    `WeightedRandomWalkIterator.java`)."""

    def _step(self, current: int) -> int:
        edges = self.graph.get_edges_out(current)
        if not edges:
            if self.no_edge_handling == NoEdgeHandling.EXCEPTION_ON_DISCONNECTED:
                raise ValueError(f"Vertex {current} has no edges")
            return current
        weights = np.array([e.weight for e in edges], np.float64)
        probs = weights / weights.sum()
        e = edges[int(self._rng.choice(len(edges), p=probs))]
        if e.directed:
            return e.dst
        return e.dst if e.src == current else e.src


class Node2VecWalkIterator(RandomWalkIterator):
    """Second-order biased walks (node2vec, Grover & Leskovec 2016;
    reference module `deeplearning4j-nlp/.../models/node2vec/`).

    Transition from current v (having arrived from t) to neighbor x is
    weighted by: 1/p if x == t (return), 1 if x is adjacent to t
    (BFS-ish stay-local), 1/q otherwise (DFS-ish explore). p is the
    return parameter, q the in-out parameter."""

    def __init__(self, graph: Graph, walk_length: int, p: float = 1.0,
                 q: float = 1.0, seed: int = 0,
                 no_edge_handling: NoEdgeHandling =
                 NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED):
        self.p = float(p)
        self.q = float(q)
        self._adj = [set(graph.get_connected_vertices(v))
                     for v in range(graph.num_vertices())]
        super().__init__(graph, walk_length, seed=seed,
                         no_edge_handling=no_edge_handling)

    def _biased_step(self, prev: int, current: int) -> int:
        neighbors = self.graph.get_connected_vertices(current)
        if not neighbors:
            if self.no_edge_handling == NoEdgeHandling.EXCEPTION_ON_DISCONNECTED:
                raise ValueError(f"Vertex {current} has no edges")
            return current
        w = np.empty(len(neighbors), np.float64)
        prev_adj = self._adj[prev]
        for i, x in enumerate(neighbors):
            if x == prev:
                w[i] = 1.0 / self.p
            elif x in prev_adj:
                w[i] = 1.0
            else:
                w[i] = 1.0 / self.q
        w /= w.sum()
        return neighbors[int(self._rng.choice(len(neighbors), p=w))]

    def next(self) -> List[int]:
        start = int(self._order[self._pos])
        self._pos += 1
        walk = [start]
        if self.walk_length < 2:
            return walk
        current = self._step(start)  # first hop is unbiased (no prev)
        walk.append(current)
        for _ in range(self.walk_length - 2):
            nxt = self._biased_step(walk[-2], current)
            walk.append(nxt)
            current = nxt
        return walk


class PopularityMode(str, Enum):
    MAXIMUM = "maximum"
    MINIMUM = "minimum"
    AVERAGE = "average"


class SpreadSpectrum(str, Enum):
    PLAIN = "plain"               # uniform within the spread window
    PROPORTIONAL = "proportional"  # degree-proportional within the window


class PopularityWalkIterator(RandomWalkIterator):
    """Degree-biased walks (reference
    `graph/walkers/impl/PopularityWalker.java`): at each hop the
    UNVISITED neighbors are ranked by their connection count, a window
    of `spread` candidates is cut per `popularity_mode`
    (MAXIMUM = most-connected end, MINIMUM = least-connected end,
    AVERAGE = middle), and the next hop is drawn from that window —
    uniformly (PLAIN) or degree-proportionally (PROPORTIONAL)."""

    def __init__(self, graph: Graph, walk_length: int,
                 popularity_mode: PopularityMode = PopularityMode.MAXIMUM,
                 spread: int = 10,
                 spectrum: SpreadSpectrum = SpreadSpectrum.PLAIN,
                 seed: int = 0,
                 no_edge_handling: NoEdgeHandling =
                 NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED):
        self.popularity_mode = PopularityMode(popularity_mode)
        self.spread = max(1, spread)
        self.spectrum = SpreadSpectrum(spectrum)
        super().__init__(graph, walk_length, seed=seed,
                         no_edge_handling=no_edge_handling)

    def next(self) -> List[int]:
        start = int(self._order[self._pos])
        self._pos += 1
        walk = [start]
        visited = {start}
        current = start
        for _ in range(self.walk_length - 1):
            neighbors = [v for v in self.graph.get_connected_vertices(current)
                         if v not in visited]
            if not neighbors:
                if (self.no_edge_handling ==
                        NoEdgeHandling.EXCEPTION_ON_DISCONNECTED):
                    raise ValueError(f"Vertex {current} has no unvisited edges")
                walk.append(current)       # self loop, like the base walker
                continue
            degrees = np.array(
                [len(self.graph.get_connected_vertices(v)) for v in neighbors])
            order = np.argsort(-degrees)   # most-popular first
            w = min(self.spread, len(neighbors))
            if self.popularity_mode == PopularityMode.MAXIMUM:
                window = order[:w]
            elif self.popularity_mode == PopularityMode.MINIMUM:
                window = order[len(order) - w:]
            else:  # AVERAGE: centered window
                mid = len(order) // 2
                lo = max(0, mid - w // 2)
                window = order[lo:lo + w]
            if self.spectrum == SpreadSpectrum.PROPORTIONAL:
                p = degrees[window].astype(np.float64)
                p = p / p.sum() if p.sum() > 0 else None
                pick = int(self._rng.choice(window, p=p))
            else:
                pick = int(window[int(self._rng.integers(len(window)))])
            current = neighbors[pick]
            visited.add(current)
            walk.append(current)
        return walk


class NearestVertexSamplingMode(str, Enum):
    RANDOM = "random"
    MAX_POPULARITY = "max_popularity"
    MEDIAN_POPULARITY = "median_popularity"
    MIN_POPULARITY = "min_popularity"


class NearestVertexWalkIterator:
    """Neighborhood sequences rather than walks (reference
    `graph/walkers/impl/NearestVertexWalker.java`): for each vertex,
    emit its connected vertices — all of them when `walk_length == 0`,
    else `walk_length` of them chosen by `sampling_mode` over the
    degree ranking; `depth > 1` recursively merges the neighbors'
    neighborhoods (deduplicated)."""

    def __init__(self, graph: Graph, walk_length: int = 0,
                 sampling_mode: NearestVertexSamplingMode =
                 NearestVertexSamplingMode.RANDOM,
                 depth: int = 1, seed: int = 0, shuffle: bool = True):
        self.graph = graph
        self.walk_length = walk_length
        self.sampling_mode = NearestVertexSamplingMode(sampling_mode)
        self.depth = max(1, depth)
        self.seed = seed
        self.shuffle = shuffle
        self.reset()

    def reset(self):
        self._rng = np.random.default_rng(self.seed)
        self._order = (self._rng.permutation(self.graph.num_vertices())
                       if self.shuffle
                       else np.arange(self.graph.num_vertices()))
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < len(self._order)

    def _pick(self, neighbors: List[int]) -> List[int]:
        if self.walk_length == 0 or len(neighbors) <= self.walk_length:
            return list(neighbors)
        L = self.walk_length
        if self.sampling_mode == NearestVertexSamplingMode.RANDOM:
            return [neighbors[i] for i in
                    self._rng.choice(len(neighbors), L, replace=False)]
        degrees = np.array(
            [len(self.graph.get_connected_vertices(v)) for v in neighbors])
        ranked = [neighbors[i] for i in np.argsort(-degrees)]
        if self.sampling_mode == NearestVertexSamplingMode.MAX_POPULARITY:
            return ranked[:L]
        if self.sampling_mode == NearestVertexSamplingMode.MIN_POPULARITY:
            return ranked[-L:]
        lo = max(0, len(ranked) // 2 - L // 2)          # MEDIAN
        return ranked[lo:lo + L]

    def _walk(self, vertex: int, c_depth: int, seen) -> List[int]:
        out = []
        for v in self._pick(self.graph.get_connected_vertices(vertex)):
            if v in seen:
                continue       # dedup bounds the recursion: each vertex
            seen.add(v)        # is expanded at most once
            out.append(v)
            if c_depth < self.depth:
                out.extend(self._walk(v, c_depth + 1, seen))
        return out

    def next(self):
        """Returns (label_vertex, neighbor_sequence) — the label is the
        center vertex (reference sets it as the sequence label)."""
        center = int(self._order[self._pos])
        self._pos += 1
        return center, self._walk(center, 1, {center})

    def __iter__(self):
        self.reset()
        while self.has_next():
            yield self.next()
