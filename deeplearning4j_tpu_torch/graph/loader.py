"""Graph loaders (reference `graph/data/GraphLoader.java`): edge-list
and adjacency-list text formats, weighted variants.

The port's own copy of `deeplearning4j_tpu/graph/loader.py`,
host code unchanged (the port imports nothing of the JAX package)."""

from __future__ import annotations

from pathlib import Path
from typing import Optional

from deeplearning4j_tpu_torch.graph.graph import Graph


class GraphLoader:
    @staticmethod
    def load_edge_list(path, num_vertices: int, directed: bool = False,
                       delimiter: Optional[str] = None) -> Graph:
        """Lines of "src dst" (reference `loadUndirectedGraphEdgeListFile`)."""
        g = Graph(num_vertices)
        for line in Path(path).read_text().splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(delimiter)
            g.add_edge(int(parts[0]), int(parts[1]), directed=directed)
        return g

    @staticmethod
    def load_weighted_edge_list(path, num_vertices: int,
                                directed: bool = False,
                                delimiter: Optional[str] = None) -> Graph:
        """Lines of "src dst weight" (reference
        `loadWeightedEdgeListFile`)."""
        g = Graph(num_vertices)
        for line in Path(path).read_text().splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(delimiter)
            g.add_edge(int(parts[0]), int(parts[1]), float(parts[2]),
                       directed=directed)
        return g

    @staticmethod
    def load_adjacency_list(path, delimiter: Optional[str] = None) -> Graph:
        """Line i: "v n1 n2 n3..." (reference `loadAdjacencyListFile`)."""
        lines = [l.strip() for l in Path(path).read_text().splitlines()
                 if l.strip() and not l.startswith("#")]
        n = max(int(v) for l in lines for v in l.split(delimiter)) + 1
        g = Graph(n)
        for line in lines:
            parts = line.split(delimiter)
            src = int(parts[0])
            for d in parts[1:]:
                g.add_edge(src, int(d), directed=True)
        return g
