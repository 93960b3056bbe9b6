"""FaceNet NN4-small2, a face-embedding model (counterpart of
`deeplearning4j_tpu/zoo/facenet.py`), as a ComputationGraph: a
GoogLeNet-style stem (7x7/2 conv, 3x3/2 max pool, LRN, 1x1 and 3x3
convs, LRN, 3x3/2 max pool), inception modules 3a/3b/3c, 4a/4e and
5a/5b whose pool branch is MAX or PNORM (p = 2) and whose 1x1, 5x5 or
pool-projection branch is dropped where its width is 0 (3c and 4e are
strided: SAME at stride 2), global average pooling, a 128-wide linear
embedding, `L2NormalizeVertex` ("embeddings") and a
`CenterLossOutputLayer` head. Adam(0.1), `WeightInit.RELU`, l2 5e-5,
96x96x3 input. `conf()` equals the JAX model's as a dict, and
`init(seed)` draws its weights."""

from __future__ import annotations

from deeplearning4j_tpu_torch.common.updaters import Adam
from deeplearning4j_tpu_torch.common.weights import WeightInit
from deeplearning4j_tpu_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph import (
    L2NormalizeVertex,
    MergeVertex,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.layers import (
    CenterLossOutputLayer,
    ConvolutionLayer,
    ConvolutionMode,
    DenseLayer,
    GlobalPoolingLayer,
    LocalResponseNormalization,
    PoolingMode,
    PoolingType,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.zoo.base import ZooModel
from deeplearning4j_tpu_torch.zoo.googlenet import max_pool_same

MAX, PNORM = PoolingMode.MAX, PoolingMode.PNORM
# name: (1x1, 3x3 reduce, 3x3, 5x5 reduce, 5x5, pool, pool projection,
# stride); a width of 0 drops that branch
MODULES = (
    ("inc3a", (64, 96, 128, 16, 32, MAX, 32, 1)),
    ("inc3b", (64, 96, 128, 32, 64, PNORM, 64, 1)),
    ("inc3c", (0, 128, 256, 32, 64, MAX, 0, 2)),
    ("inc4a", (256, 96, 192, 32, 64, PNORM, 128, 1)),
    ("inc4e", (0, 160, 256, 64, 128, MAX, 0, 2)),
    ("inc5a", (256, 96, 384, 0, 0, PNORM, 96, 1)),
    ("inc5b", (256, 96, 384, 0, 0, MAX, 96, 1)),
)


class FaceNetNN4Small2(ZooModel):
    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 height: int = 96, width: int = 96, channels: int = 3,
                 embedding_size: int = 128):
        super().__init__(num_classes=num_classes, seed=seed)
        self.height, self.width, self.channels = height, width, channels
        self.embedding_size = embedding_size

    @staticmethod
    def _conv(g, name, inp, filters, kernel, stride=(1, 1)):
        g.add_layer(name, ConvolutionLayer(
            n_out=filters, kernel_size=kernel, stride=stride,
            convolution_mode=ConvolutionMode.SAME, activation="relu"), inp)
        return name

    def _inception(self, g, name, inp, spec):
        n1, r3, n3, r5, n5, pool_mode, pp, s = spec
        stride, branches = (s, s), []
        if n1:
            branches.append(self._conv(g, f"{name}_1x1", inp, n1, (1, 1)))
        b3r = self._conv(g, f"{name}_3x3r", inp, r3, (1, 1))
        branches.append(self._conv(g, f"{name}_3x3", b3r, n3, (3, 3),
                                   stride))
        if n5:
            b5r = self._conv(g, f"{name}_5x5r", inp, r5, (1, 1))
            branches.append(self._conv(g, f"{name}_5x5", b5r, n5, (5, 5),
                                       stride))
        g.add_layer(f"{name}_pool", SubsamplingLayer(
            kernel_size=(3, 3), stride=stride, pooling_type=pool_mode,
            convolution_mode=ConvolutionMode.SAME), inp)
        branches.append(self._conv(g, f"{name}_poolproj", f"{name}_pool",
                                   pp, (1, 1)) if pp else f"{name}_pool")
        g.add_vertex(f"{name}_merge", MergeVertex(), *branches)
        return f"{name}_merge"

    def conf(self) -> ComputationGraphConfiguration:
        g = ComputationGraphConfiguration.graph_builder(
            NeuralNetConfiguration.builder().seed(self.seed)
            .updater(Adam(0.1)).weight_init(WeightInit.RELU).l2(5e-5))
        g.add_inputs("input")
        g.set_input_types(InputType.convolutional(self.height, self.width,
                                                  self.channels))
        x = self._conv(g, "stem1", "input", 64, (7, 7), (2, 2))
        g.add_layer("stem_pool1", max_pool_same(2), x)
        g.add_layer("stem_lrn1", LocalResponseNormalization(), "stem_pool1")
        x = self._conv(g, "stem2", "stem_lrn1", 64, (1, 1))
        x = self._conv(g, "stem3", x, 192, (3, 3))
        g.add_layer("stem_lrn2", LocalResponseNormalization(), x)
        g.add_layer("stem_pool2", max_pool_same(2), "stem_lrn2")
        x = "stem_pool2"
        for name, spec in MODULES:
            x = self._inception(g, name, x, spec)
        g.add_layer("avgpool", GlobalPoolingLayer(
            pooling_type=PoolingType.AVG), x)
        g.add_layer("bottleneck", DenseLayer(
            n_out=self.embedding_size, activation="identity"), "avgpool")
        g.add_vertex("embeddings", L2NormalizeVertex(), "bottleneck")
        g.add_layer("output", CenterLossOutputLayer(
            n_out=self.num_classes, activation="softmax", loss="mcxent",
            alpha=0.9, lambda_=2e-4), "embeddings")
        g.set_outputs("output")
        return g.build()
