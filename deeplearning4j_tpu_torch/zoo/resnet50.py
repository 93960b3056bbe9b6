"""ResNet-50, the JAX package's north-star model (counterpart of
`deeplearning4j_tpu/zoo/resnet50.py:34-99`): a 7x7/2 SAME stem conv +
BatchNorm + relu and a 3x3/2 SAME max pool, bottleneck stages
[3, 4, 6, 3] (a projection shortcut at each stage's first block, the
stride on its first 1x1), `ElementWiseVertex("add")` then relu, global
average pooling and a softmax/mcxent output, as a ComputationGraph
trained by Nesterovs(0.1, 0.9) with `WeightInit.RELU` and l2 1e-4.
`conf()` equals the JAX model's as a dict.

`init_pretrained(IMAGENET)` takes the keras-applications weights-only
file through `resnet50_keras_arch.json` (JAX `zoo/resnet50.py:104-105`):
keras's ResNet-50 (explicit ZeroPadding, biased convs) is not this
builder's graph, so the committed `model.to_json()` routes the import.
The port downloads nothing: a caller serves the file through
`pretrained_path` and `pretrained_checksum`.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.common.updaters import Nesterovs
from deeplearning4j_tpu_torch.common.weights import WeightInit
from deeplearning4j_tpu_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph import ElementWiseVertex
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.layers import (
    ActivationLayer,
    BatchNormalization,
    ConvolutionLayer,
    ConvolutionMode,
    GlobalPoolingLayer,
    OutputLayer,
    PoolingType,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.zoo.base import PretrainedType, ZooModel


class ResNet50(ZooModel):
    STAGES = [(3, 64), (4, 128), (6, 256), (3, 512)]
    keras_architecture = {PretrainedType.IMAGENET:
                          "resnet50_keras_arch.json"}

    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 height: int = 224, width: int = 224, channels: int = 3):
        super().__init__(num_classes=num_classes, seed=seed)
        self.height, self.width, self.channels = height, width, channels

    def _conv_bn(self, g, name, inp, filters, kernel, stride,
                 activation=True):
        g.add_layer(f"{name}_conv",
                    ConvolutionLayer(n_out=filters, kernel_size=kernel,
                                     stride=stride,
                                     convolution_mode=ConvolutionMode.SAME,
                                     has_bias=False, activation="identity"),
                    inp)
        g.add_layer(f"{name}_bn", BatchNormalization(
            activation="relu" if activation else "identity"), f"{name}_conv")
        return f"{name}_bn"

    def _bottleneck(self, g, name, inp, filters, stride, project):
        x = self._conv_bn(g, f"{name}_a", inp, filters, (1, 1),
                          (stride, stride))
        x = self._conv_bn(g, f"{name}_b", x, filters, (3, 3), (1, 1))
        x = self._conv_bn(g, f"{name}_c", x, 4 * filters, (1, 1), (1, 1),
                          activation=False)
        shortcut = (self._conv_bn(g, f"{name}_proj", inp, 4 * filters,
                                  (1, 1), (stride, stride), activation=False)
                    if project else inp)
        g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), x, shortcut)
        g.add_layer(f"{name}_out", ActivationLayer(activation="relu"),
                    f"{name}_add")
        return f"{name}_out"

    def conf(self) -> ComputationGraphConfiguration:
        g = ComputationGraphConfiguration.graph_builder(
            NeuralNetConfiguration.builder().seed(self.seed)
            .updater(Nesterovs(1e-1, 0.9)).weight_init(WeightInit.RELU)
            .l2(1e-4))
        g.add_inputs("input")
        g.set_input_types(InputType.convolutional(self.height, self.width,
                                                  self.channels))
        x = self._conv_bn(g, "stem", "input", 64, (7, 7), (2, 2))
        g.add_layer("stem_pool", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2),
            convolution_mode=ConvolutionMode.SAME), x)
        x = "stem_pool"
        for si, (blocks, filters) in enumerate(self.STAGES):
            for bi in range(blocks):
                stride = 2 if (si > 0 and bi == 0) else 1
                x = self._bottleneck(g, f"res{si}_{bi}", x, filters, stride,
                                     project=(bi == 0))
        g.add_layer("avgpool", GlobalPoolingLayer(
            pooling_type=PoolingType.AVG), x)
        g.add_layer("output", OutputLayer(n_out=self.num_classes,
                                          activation="softmax",
                                          loss="mcxent"), "avgpool")
        g.set_outputs("output")
        return g.build()
