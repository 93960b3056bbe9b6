"""AlexNet (counterpart of `deeplearning4j_tpu/zoo/alexnet.py`): conv
11x11/4 (96) + LRN + max pool 3/2 -> conv 5x5 (256, pad 2) + LRN + max
pool -> conv 3x3 (384, 384, 256; pad 1) + max pool -> dense 4096 x 2
with dropout (retain 0.5) -> softmax output, every conv TRUNCATE.
Nesterovs(1e-2, 0.9), l2 5e-4, weights from `NormalDistribution(0,
0.01)`, bias 1.0 on cnn2, cnn4, cnn5 and the dense layers; 224x224x3
input. `conf()` equals the JAX model's as a dict, and `init(seed)`
draws its weights."""

from __future__ import annotations

from deeplearning4j_tpu_torch.common.distributions import NormalDistribution
from deeplearning4j_tpu_torch.common.updaters import Nesterovs
from deeplearning4j_tpu_torch.common.weights import WeightInit
from deeplearning4j_tpu_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    ConvolutionLayer,
    DenseLayer,
    LocalResponseNormalization,
    OutputLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.zoo.base import ZooModel


class AlexNet(ZooModel):
    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 height: int = 224, width: int = 224, channels: int = 3):
        super().__init__(num_classes=num_classes, seed=seed)
        self.height, self.width, self.channels = height, width, channels

    def conf(self):
        def conv(name, n_out, kernel, stride=(1, 1), padding=(0, 0),
                 **kw):
            return ConvolutionLayer(n_out=n_out, kernel_size=kernel,
                                    stride=stride, padding=padding,
                                    activation="relu", name=name, **kw)

        def pool(name):
            return SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2),
                                    name=name)
        return (NeuralNetConfiguration.builder()
                .seed(self.seed)
                .updater(Nesterovs(1e-2, 0.9))
                .weight_init(WeightInit.DISTRIBUTION)
                .dist(NormalDistribution(0.0, 0.01))
                .l2(5e-4)
                .list()
                .layer(conv("cnn1", 96, (11, 11), (4, 4)))
                .layer(LocalResponseNormalization(name="lrn1"))
                .layer(pool("maxpool1"))
                .layer(conv("cnn2", 256, (5, 5), padding=(2, 2),
                            bias_init=1.0))
                .layer(LocalResponseNormalization(name="lrn2"))
                .layer(pool("maxpool2"))
                .layer(conv("cnn3", 384, (3, 3), padding=(1, 1)))
                .layer(conv("cnn4", 384, (3, 3), padding=(1, 1),
                            bias_init=1.0))
                .layer(conv("cnn5", 256, (3, 3), padding=(1, 1),
                            bias_init=1.0))
                .layer(pool("maxpool3"))
                .layer(DenseLayer(n_out=4096, activation="relu",
                                  bias_init=1.0, dropout=0.5, name="ffn1"))
                .layer(DenseLayer(n_out=4096, activation="relu",
                                  bias_init=1.0, dropout=0.5, name="ffn2"))
                .layer(OutputLayer(n_out=self.num_classes,
                                   activation="softmax", loss="mcxent",
                                   name="output"))
                .set_input_type(InputType.convolutional(
                    self.height, self.width, self.channels))
                .build())
