"""Graph-embedding library (counterpart of `deeplearning4j_tpu/graph/`;
reference: deeplearning4j-graph, SURVEY §2.6): IGraph/Graph, loaders,
random-walk iterators (host numpy), DeepWalk, Node2Vec, GraphVectors
(trained on `device` through the SequenceVectors engine)."""

from deeplearning4j_tpu_torch.graph.graph import Graph, Edge, Vertex
from deeplearning4j_tpu_torch.graph.loader import GraphLoader
from deeplearning4j_tpu_torch.graph.walkers import (
    NearestVertexSamplingMode,
    NearestVertexWalkIterator,
    NoEdgeHandling,
    Node2VecWalkIterator,
    PopularityMode,
    PopularityWalkIterator,
    RandomWalkIterator,
    SpreadSpectrum,
    WeightedRandomWalkIterator,
)
from deeplearning4j_tpu_torch.graph.deepwalk import DeepWalk, GraphVectors
from deeplearning4j_tpu_torch.graph.node2vec import Node2Vec
