"""SimpleCNN (counterpart of `deeplearning4j_tpu/zoo/simplecnn.py`): two
SAME 3x3 conv (16, 32; relu) + BatchNormalization + max pool 2 blocks,
dense 128 (relu) with dropout (retain 0.5), softmax output; Adam(1e-3),
`WeightInit.RELU`, 48x48x3 input. `conf()` equals the JAX model's as a
dict, and `init(seed)` draws its weights."""

from __future__ import annotations

from deeplearning4j_tpu_torch.common.updaters import Adam
from deeplearning4j_tpu_torch.common.weights import WeightInit
from deeplearning4j_tpu_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    BatchNormalization,
    ConvolutionLayer,
    ConvolutionMode,
    DenseLayer,
    OutputLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.zoo.base import ZooModel


class SimpleCNN(ZooModel):
    def __init__(self, num_classes: int = 10, seed: int = 123,
                 height: int = 48, width: int = 48, channels: int = 3):
        super().__init__(num_classes=num_classes, seed=seed)
        self.height, self.width, self.channels = height, width, channels

    def conf(self):
        b = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(Adam(1e-3))
             .weight_init(WeightInit.RELU)
             .list())
        for n_out in (16, 32):
            (b.layer(ConvolutionLayer(n_out=n_out, kernel_size=(3, 3),
                                      stride=(1, 1),
                                      convolution_mode=ConvolutionMode.SAME,
                                      activation="relu"))
             .layer(BatchNormalization())
             .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2))))
        return (b.layer(DenseLayer(n_out=128, activation="relu", dropout=0.5))
                .layer(OutputLayer(n_out=self.num_classes,
                                   activation="softmax", loss="mcxent"))
                .set_input_type(InputType.convolutional(
                    self.height, self.width, self.channels))
                .build())
