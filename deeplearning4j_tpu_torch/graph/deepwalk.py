"""DeepWalk graph embeddings (counterpart of
`deeplearning4j_tpu/graph/deepwalk.py`).

Reference: `graph/models/deepwalk/DeepWalk.java` (+ `GraphHuffman.java`
hierarchical-softmax tree over vertex degree frequencies,
`GraphVectorsImpl`, `InMemoryGraphLookupTable`).

Walks from the RandomWalkIterator (numpy, host) become token sequences
(vertex ids as tokens) fed to the batched SequenceVectors engine with
hierarchical softmax — the skip-gram-over-walks algorithm, on `device`.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch.graph.graph import Graph
from deeplearning4j_tpu_torch.graph.walkers import RandomWalkIterator
from deeplearning4j_tpu_torch.nlp.sequencevectors import (
    SequenceVectors,
    SequenceVectorsConfig,
)


class GraphVectors(SequenceVectors):
    """Vertex-embedding query surface (reference `GraphVectors.java`:
    getVertexVector, verticesNearest, similarity) + the shared
    walk-collection/vocab-bootstrap loop; subclasses provide the walker
    via `_make_walker`."""

    walk_length: int = 40
    walks_per_vertex: int = 1

    def get_vertex_vector(self, idx: int) -> Optional[np.ndarray]:
        return self.get_word_vector(str(idx))

    def vertices_nearest(self, idx: int, top_n: int = 10) -> List[int]:
        return [int(w) for w in self.words_nearest(str(idx), top_n)]

    def similarity_vertices(self, a: int, b: int) -> float:
        return self.similarity(str(a), str(b))

    def _make_walker(self, graph: Graph, rep: int):
        raise NotImplementedError

    def initialize(self, graph: Graph):
        """Pre-build vocab over all vertices (reference
        `DeepWalk.initialize(graph)` builds the GraphHuffman tree from
        vertex degrees)."""
        sequences = [[str(v)] * max(graph.degree(v), 1)
                     for v in range(graph.num_vertices())]
        self.build_vocab(sequences)
        return self

    def fit_graph(self, graph: Graph, walk_iterator=None):
        if self.vocab is None:
            self.initialize(graph)
        walks: List[List[str]] = []
        for rep in range(self.walks_per_vertex):
            it = walk_iterator or self._make_walker(graph, rep)
            it.reset()
            for walk in it:
                walks.append([str(v) for v in walk])
            walk_iterator = None  # only reuse the custom iterator once
        return super().fit(walks,
                           total_words=sum(len(w) for w in walks))


class DeepWalk(GraphVectors):
    """`DeepWalk.Builder` options → constructor kwargs
    (vectorSize→vector_length, windowSize→window, learningRate)."""

    def __init__(self, vector_size: int = 100, window_size: int = 5,
                 learning_rate: float = 0.025, walk_length: int = 40,
                 walks_per_vertex: int = 1, epochs: int = 1,
                 batch_size: int = 2048, seed: int = 42,
                 device="cuda"):
        super().__init__(SequenceVectorsConfig(
            vector_length=vector_size, window=window_size,
            learning_rate=learning_rate, min_word_frequency=1,
            use_hierarchic_softmax=True, negative=0,  # HS like the reference
            epochs=epochs, batch_size=batch_size, seed=seed),
            device=device)
        self.walk_length = walk_length
        self.walks_per_vertex = walks_per_vertex

    def _make_walker(self, graph: Graph, rep: int):
        return RandomWalkIterator(graph, self.walk_length,
                                  seed=self.conf.seed + rep)
