"""VGG16 and VGG19 (counterpart of `deeplearning4j_tpu/zoo/vgg.py`):
SAME 3x3 conv stacks (relu) each closed by a max pool 2, then dense
4096 x 2 with dropout (retain 0.5) and a softmax output; Nesterovs(1e-2,
0.9), `WeightInit.RELU`, 224x224x3 input. `conf()` equals the JAX
model's as a dict, and `init(seed)` draws its weights (VGG16's 138 M in
one threefry call per tensor, fc1's 25088 x 4096 the largest).

The JAX package's IMAGENET weights are the Keras h5 files it downloads;
the port downloads nothing and has no Keras importer, so
`init_pretrained(IMAGENET)` is refused by name (`zoo/base.py`).
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.common.updaters import Nesterovs
from deeplearning4j_tpu_torch.common.weights import WeightInit
from deeplearning4j_tpu_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    ConvolutionLayer,
    ConvolutionMode,
    DenseLayer,
    OutputLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.zoo.base import ZooModel


class VGG16(ZooModel):
    BLOCKS = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]

    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 height: int = 224, width: int = 224, channels: int = 3):
        super().__init__(num_classes=num_classes, seed=seed)
        self.height, self.width, self.channels = height, width, channels

    def conf(self):
        b = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(Nesterovs(1e-2, 0.9))
             .weight_init(WeightInit.RELU)
             .list())
        i = 0
        for filters, reps in self.BLOCKS:
            for _ in range(reps):
                b.layer(ConvolutionLayer(
                    n_out=filters, kernel_size=(3, 3), stride=(1, 1),
                    convolution_mode=ConvolutionMode.SAME,
                    activation="relu", name=f"conv{i}"))
                i += 1
            b.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2),
                                     name=f"pool{i}"))
        return (b.layer(DenseLayer(n_out=4096, activation="relu",
                                   dropout=0.5, name="fc1"))
                .layer(DenseLayer(n_out=4096, activation="relu",
                                  dropout=0.5, name="fc2"))
                .layer(OutputLayer(n_out=self.num_classes,
                                   activation="softmax", loss="mcxent",
                                   name="output"))
                .set_input_type(InputType.convolutional(
                    self.height, self.width, self.channels))
                .build())



class VGG19(VGG16):
    BLOCKS = [(64, 2), (128, 2), (256, 4), (512, 4), (512, 4)]
