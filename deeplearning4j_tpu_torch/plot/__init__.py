"""Embedding visualization (counterpart of `deeplearning4j_tpu/plot/`;
reference: deeplearning4j-core `plot/`)."""

from deeplearning4j_tpu_torch.plot.tsne import BarnesHutTsne, Tsne
