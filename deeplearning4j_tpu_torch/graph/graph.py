"""Graph data structure.

Reference: `graph/api/IGraph.java` + `graph/graph/Graph.java`: vertices
with optional values, directed or undirected weighted edges, adjacency
queries.

The port's own copy of `deeplearning4j_tpu/graph/graph.py`,
host code unchanged (the port imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Any, List


class Vertex:
    __slots__ = ("idx", "value")

    def __init__(self, idx: int, value: Any = None):
        self.idx = idx
        self.value = value

    def __repr__(self):
        return f"Vertex({self.idx}, {self.value!r})"


class Edge:
    __slots__ = ("src", "dst", "weight", "directed")

    def __init__(self, src: int, dst: int, weight: float = 1.0,
                 directed: bool = False):
        self.src = src
        self.dst = dst
        self.weight = weight
        self.directed = directed

    def __repr__(self):
        arrow = "→" if self.directed else "—"
        return f"Edge({self.src}{arrow}{self.dst}, w={self.weight})"


class Graph:
    """Adjacency-list graph (reference `Graph.java`)."""

    def __init__(self, num_vertices: int, allow_multiple_edges: bool = True):
        self.vertices = [Vertex(i) for i in range(num_vertices)]
        self.allow_multiple_edges = allow_multiple_edges
        self._adj: List[List[Edge]] = [[] for _ in range(num_vertices)]

    def num_vertices(self) -> int:
        return len(self.vertices)

    def get_vertex(self, idx: int) -> Vertex:
        return self.vertices[idx]

    def add_edge(self, src: int, dst: int, weight: float = 1.0,
                 directed: bool = False):
        e = Edge(src, dst, weight, directed)
        if not self.allow_multiple_edges:
            for ex in self._adj[src]:
                if ex.dst == dst or (not ex.directed and ex.src == dst):
                    return
        self._adj[src].append(e)
        if not directed:
            self._adj[dst].append(e)

    def get_edges_out(self, vertex: int) -> List[Edge]:
        return list(self._adj[vertex])

    def get_connected_vertices(self, vertex: int) -> List[int]:
        # undirected edges are stored on both ends; report the "other" side
        return [(e.dst if e.src == vertex else e.src) if not e.directed
                else e.dst for e in self._adj[vertex]]

    def degree(self, vertex: int) -> int:
        return len(self._adj[vertex])
