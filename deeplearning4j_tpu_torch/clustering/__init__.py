"""Nearest-neighbors + clustering library (counterpart of
`deeplearning4j_tpu/clustering/`; reference:
deeplearning4j-nearestneighbors-parent, SURVEY §2.7): VPTree, KDTree,
QuadTree, SpTree (Barnes-Hut), k-means, and the REST server. The trees
and the server are host numpy; k-means' Lloyd steps run on `device`.
"""

from deeplearning4j_tpu_torch.clustering.vptree import VPTree
from deeplearning4j_tpu_torch.clustering.kdtree import KDTree
from deeplearning4j_tpu_torch.clustering.quadtree import QuadTree
from deeplearning4j_tpu_torch.clustering.sptree import SpTree
from deeplearning4j_tpu_torch.clustering.kmeans import KMeansClustering, ClusterSet
