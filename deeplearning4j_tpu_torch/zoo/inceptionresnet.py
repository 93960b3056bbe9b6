"""InceptionResNetV1, the face-embedding backbone (counterpart of
`deeplearning4j_tpu/zoo/inceptionresnet.py`), as a ComputationGraph: a
stem of SAME convs (3x3/2, 3x3, 3x3, 3x3/2 max pool, 1x1, 3x3,
3x3/2), `blocks35` Inception-ResNet-A blocks, reduction A,
`blocks17` B blocks (1x7 and 7x1 convs), reduction B, `blocks8` C
blocks (1x3 and 3x1), global average pooling, a 128-wide linear
bottleneck with dropout (retain 0.8), `L2NormalizeVertex` ("embeddings")
and a `CenterLossOutputLayer` head. Each block merges its branches,
expands them with a linear 1x1 conv, scales that by `ScaleVertex`
(0.17, 0.10, 0.20), adds it to its input and applies relu.
RmsProp(0.1), `WeightInit.RELU`, l2 5e-5, 160x160x3 input. `conf()`
equals the JAX model's as a dict, and `init(seed)` draws its weights."""

from __future__ import annotations

from deeplearning4j_tpu_torch.common.updaters import RmsProp
from deeplearning4j_tpu_torch.common.weights import WeightInit
from deeplearning4j_tpu_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph import (
    ElementWiseVertex,
    L2NormalizeVertex,
    MergeVertex,
    ScaleVertex,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.layers import (
    ActivationLayer,
    CenterLossOutputLayer,
    ConvolutionLayer,
    ConvolutionMode,
    DenseLayer,
    GlobalPoolingLayer,
    PoolingType,
)
from deeplearning4j_tpu_torch.zoo.base import ZooModel
from deeplearning4j_tpu_torch.zoo.googlenet import max_pool_same


class InceptionResNetV1(ZooModel):
    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 height: int = 160, width: int = 160, channels: int = 3,
                 embedding_size: int = 128, blocks35: int = 5,
                 blocks17: int = 10, blocks8: int = 5):
        super().__init__(num_classes=num_classes, seed=seed)
        self.height, self.width, self.channels = height, width, channels
        self.embedding_size = embedding_size
        self.blocks35, self.blocks17, self.blocks8 = (blocks35, blocks17,
                                                      blocks8)

    @staticmethod
    def _conv(g, name, inp, filters, kernel, stride=(1, 1), act="relu"):
        g.add_layer(name, ConvolutionLayer(
            n_out=filters, kernel_size=kernel, stride=stride,
            convolution_mode=ConvolutionMode.SAME, activation=act), inp)
        return name

    def _residual(self, g, name, inp, branches, n_channels, scale):
        """merge -> linear 1x1 expand -> scale -> add the input -> relu"""
        g.add_vertex(f"{name}_merge", MergeVertex(), *branches)
        up = self._conv(g, f"{name}_up", f"{name}_merge", n_channels,
                        (1, 1), act="identity")
        g.add_vertex(f"{name}_scale", ScaleVertex(scale_factor=scale), up)
        g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), inp,
                     f"{name}_scale")
        g.add_layer(f"{name}_relu", ActivationLayer(activation="relu"),
                    f"{name}_add")
        return f"{name}_relu"

    def _chain(self, g, inp, specs):
        """Convs one after another: (name, filters, kernel[, stride])."""
        x = inp
        for name, filters, kernel, *stride in specs:
            x = self._conv(g, name, x, filters, kernel, *stride)
        return x

    def _block35(self, g, name, inp):
        b1 = self._conv(g, f"{name}_b1", inp, 32, (1, 1))
        b2 = self._chain(g, inp, [(f"{name}_b2a", 32, (1, 1)),
                                  (f"{name}_b2b", 32, (3, 3))])
        b3 = self._chain(g, inp, [(f"{name}_b3a", 32, (1, 1)),
                                  (f"{name}_b3b", 32, (3, 3)),
                                  (f"{name}_b3c", 32, (3, 3))])
        return self._residual(g, name, inp, (b1, b2, b3), 256, 0.17)

    def _block17(self, g, name, inp):
        b1 = self._conv(g, f"{name}_b1", inp, 128, (1, 1))
        b2 = self._chain(g, inp, [(f"{name}_b2a", 128, (1, 1)),
                                  (f"{name}_b2b", 128, (1, 7)),
                                  (f"{name}_b2c", 128, (7, 1))])
        return self._residual(g, name, inp, (b1, b2), 896, 0.10)

    def _block8(self, g, name, inp):
        b1 = self._conv(g, f"{name}_b1", inp, 192, (1, 1))
        b2 = self._chain(g, inp, [(f"{name}_b2a", 192, (1, 1)),
                                  (f"{name}_b2b", 192, (1, 3)),
                                  (f"{name}_b2c", 192, (3, 1))])
        return self._residual(g, name, inp, (b1, b2), 1792, 0.20)

    def conf(self) -> ComputationGraphConfiguration:
        g = ComputationGraphConfiguration.graph_builder(
            NeuralNetConfiguration.builder().seed(self.seed)
            .updater(RmsProp(0.1)).weight_init(WeightInit.RELU).l2(5e-5))
        g.add_inputs("input")
        g.set_input_types(InputType.convolutional(self.height, self.width,
                                                  self.channels))
        x = self._chain(g, "input", [("stem1", 32, (3, 3), (2, 2)),
                                     ("stem2", 32, (3, 3)),
                                     ("stem3", 64, (3, 3))])
        g.add_layer("stem_pool", max_pool_same(2), x)
        x = self._chain(g, "stem_pool", [("stem4", 80, (1, 1)),
                                         ("stem5", 192, (3, 3)),
                                         ("stem6", 256, (3, 3), (2, 2))])
        for i in range(self.blocks35):
            x = self._block35(g, f"block35_{i}", x)
        g.add_layer("redA_pool", max_pool_same(2), x)
        ra1 = self._conv(g, "redA_b1", x, 384, (3, 3), (2, 2))
        ra2 = self._chain(g, x, [("redA_b2a", 192, (1, 1)),
                                 ("redA_b2b", 192, (3, 3)),
                                 ("redA_b2c", 256, (3, 3), (2, 2))])
        g.add_vertex("redA", MergeVertex(), "redA_pool", ra1, ra2)
        x = "redA"
        for i in range(self.blocks17):
            x = self._block17(g, f"block17_{i}", x)
        g.add_layer("redB_pool", max_pool_same(2), x)
        rb1 = self._chain(g, x, [("redB_b1a", 256, (1, 1)),
                                 ("redB_b1b", 384, (3, 3), (2, 2))])
        rb2 = self._chain(g, x, [("redB_b2a", 256, (1, 1)),
                                 ("redB_b2b", 256, (3, 3), (2, 2))])
        rb3 = self._chain(g, x, [("redB_b3a", 256, (1, 1)),
                                 ("redB_b3b", 256, (3, 3)),
                                 ("redB_b3c", 256, (3, 3), (2, 2))])
        g.add_vertex("redB", MergeVertex(), "redB_pool", rb1, rb2, rb3)
        x = "redB"
        for i in range(self.blocks8):
            x = self._block8(g, f"block8_{i}", x)
        g.add_layer("avgpool", GlobalPoolingLayer(
            pooling_type=PoolingType.AVG), x)
        g.add_layer("bottleneck", DenseLayer(
            n_out=self.embedding_size, activation="identity", dropout=0.8),
            "avgpool")
        g.add_vertex("embeddings", L2NormalizeVertex(), "bottleneck")
        g.add_layer("output", CenterLossOutputLayer(
            n_out=self.num_classes, activation="softmax", loss="mcxent",
            alpha=0.9, lambda_=2e-4), "embeddings")
        g.set_outputs("output")
        return g.build()
