"""GoogLeNet, Inception v1 (counterpart of
`deeplearning4j_tpu/zoo/googlenet.py`), as a ComputationGraph: a stem
(7x7/2 conv, 3x3/2 max pool, LRN, 1x1 and 3x3 convs, LRN, 3x3/2 max
pool), nine inception modules (3a/3b, 4a-4e, 5a/5b) each merging four
branches on the channel axis (1x1; 1x1 -> 3x3; 1x1 -> 5x5; 3x3/1 max
pool -> 1x1), 3x3/2 max pools between the stages, global average
pooling, fc1 1024 (relu) with dropout (retain 0.4) and a softmax
output. Every conv and pool is SAME (uneven at stride 2 on even
sizes); Nesterovs(1e-2, 0.9), `WeightInit.RELU`, l2 5e-4, 224x224x3
input. `conf()` equals the JAX model's as a dict, and `init(seed)`
draws its weights."""

from __future__ import annotations

from deeplearning4j_tpu_torch.common.updaters import Nesterovs
from deeplearning4j_tpu_torch.common.weights import WeightInit
from deeplearning4j_tpu_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph import MergeVertex
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.layers import (
    ConvolutionLayer,
    ConvolutionMode,
    DenseLayer,
    GlobalPoolingLayer,
    LocalResponseNormalization,
    OutputLayer,
    PoolingType,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.zoo.base import ZooModel

# (1x1, (3x3 reduce, 3x3), (5x5 reduce, 5x5), pool projection) per module
INCEPTION = {
    "3a": (64, (96, 128), (16, 32), 32),
    "3b": (128, (128, 192), (32, 96), 64),
    "4a": (192, (96, 208), (16, 48), 64),
    "4b": (160, (112, 224), (24, 64), 64),
    "4c": (128, (128, 256), (24, 64), 64),
    "4d": (112, (144, 288), (32, 64), 64),
    "4e": (256, (160, 320), (32, 128), 128),
    "5a": (256, (160, 320), (32, 128), 128),
    "5b": (384, (192, 384), (48, 128), 128),
}


def max_pool_same(stride):
    return SubsamplingLayer(kernel_size=(3, 3), stride=(stride, stride),
                            convolution_mode=ConvolutionMode.SAME)


class GoogLeNet(ZooModel):
    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 height: int = 224, width: int = 224, channels: int = 3):
        super().__init__(num_classes=num_classes, seed=seed)
        self.height, self.width, self.channels = height, width, channels

    @staticmethod
    def _conv(g, name, inp, filters, kernel, stride=(1, 1)):
        g.add_layer(name, ConvolutionLayer(
            n_out=filters, kernel_size=kernel, stride=stride,
            convolution_mode=ConvolutionMode.SAME, activation="relu"), inp)
        return name

    def _inception(self, g, name, inp, spec):
        n1, (r3, n3), (r5, n5), pp = spec
        b1 = self._conv(g, f"{name}_1x1", inp, n1, (1, 1))
        b2 = self._conv(g, f"{name}_3x3",
                        self._conv(g, f"{name}_3x3r", inp, r3, (1, 1)),
                        n3, (3, 3))
        b3 = self._conv(g, f"{name}_5x5",
                        self._conv(g, f"{name}_5x5r", inp, r5, (1, 1)),
                        n5, (5, 5))
        g.add_layer(f"{name}_pool", max_pool_same(1), inp)
        b4 = self._conv(g, f"{name}_poolproj", f"{name}_pool", pp, (1, 1))
        g.add_vertex(f"{name}_merge", MergeVertex(), b1, b2, b3, b4)
        return f"{name}_merge"

    def conf(self) -> ComputationGraphConfiguration:
        g = ComputationGraphConfiguration.graph_builder(
            NeuralNetConfiguration.builder().seed(self.seed)
            .updater(Nesterovs(1e-2, 0.9)).weight_init(WeightInit.RELU)
            .l2(5e-4))
        g.add_inputs("input")
        g.set_input_types(InputType.convolutional(self.height, self.width,
                                                  self.channels))
        x = self._conv(g, "stem_conv1", "input", 64, (7, 7), (2, 2))
        g.add_layer("stem_pool1", max_pool_same(2), x)
        g.add_layer("stem_lrn1", LocalResponseNormalization(), "stem_pool1")
        x = self._conv(g, "stem_conv2", "stem_lrn1", 64, (1, 1))
        x = self._conv(g, "stem_conv3", x, 192, (3, 3))
        g.add_layer("stem_lrn2", LocalResponseNormalization(), x)
        g.add_layer("stem_pool2", max_pool_same(2), "stem_lrn2")
        x = "stem_pool2"
        for stage, pool in ((("3a", "3b"), "pool3"),
                            (("4a", "4b", "4c", "4d", "4e"), "pool4"),
                            (("5a", "5b"), None)):
            for name in stage:
                x = self._inception(g, f"inc{name}", x, INCEPTION[name])
            if pool:
                g.add_layer(pool, max_pool_same(2), x)
                x = pool
        g.add_layer("avgpool", GlobalPoolingLayer(
            pooling_type=PoolingType.AVG), x)
        # a float dropout is the RETAIN probability (the reference's 0.4)
        g.add_layer("fc1", DenseLayer(n_out=1024, activation="relu",
                                      dropout=0.4), "avgpool")
        g.add_layer("output", OutputLayer(
            n_out=self.num_classes, activation="softmax", loss="mcxent"),
            "fc1")
        g.set_outputs("output")
        return g.build()
