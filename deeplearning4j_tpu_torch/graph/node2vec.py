"""Node2Vec — p/q-biased walks + skip-gram with negative sampling
(counterpart of `deeplearning4j_tpu/graph/node2vec.py`).

Reference: `deeplearning4j-nlp/.../models/node2vec/Node2Vec.java`
(builds on SequenceVectors like Word2Vec/DeepWalk). The walk bias is
the node2vec second-order scheme (Node2VecWalkIterator); training runs
the batched device skip-gram engine (`nlp/sequencevectors.py`) with
negative sampling — node2vec's published objective — instead of
DeepWalk's hierarchical softmax.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.graph.deepwalk import GraphVectors
from deeplearning4j_tpu_torch.graph.graph import Graph
from deeplearning4j_tpu_torch.graph.walkers import Node2VecWalkIterator
from deeplearning4j_tpu_torch.nlp.sequencevectors import SequenceVectorsConfig


class Node2Vec(GraphVectors):
    """p = return parameter, q = in-out parameter (q > 1 biases walks
    to stay near the start vertex — community structure; q < 1 explores
    outward — structural roles)."""

    def __init__(self, vector_size: int = 100, window_size: int = 5,
                 learning_rate: float = 0.025, walk_length: int = 40,
                 walks_per_vertex: int = 1, p: float = 1.0, q: float = 1.0,
                 negative: int = 5, epochs: int = 1, batch_size: int = 2048,
                 seed: int = 42, device="cuda"):
        super().__init__(SequenceVectorsConfig(
            vector_length=vector_size, window=window_size,
            learning_rate=learning_rate, min_word_frequency=1,
            use_hierarchic_softmax=False, negative=negative,
            epochs=epochs, batch_size=batch_size, seed=seed),
            device=device)
        self.walk_length = walk_length
        self.walks_per_vertex = walks_per_vertex
        self.p = p
        self.q = q

    def _make_walker(self, graph: Graph, rep: int):
        return Node2VecWalkIterator(graph, self.walk_length, p=self.p,
                                    q=self.q, seed=self.conf.seed + rep)
