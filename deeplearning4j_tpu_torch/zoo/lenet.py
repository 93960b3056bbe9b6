"""LeNet (counterpart of `deeplearning4j_tpu/zoo/lenet.py`), the JAX
benchmark's configuration 0: conv 5x5 (20, relu) -> max pool 2 -> conv
5x5 (50, relu) -> max pool 2 -> dense 500 (relu) -> softmax output,
Adam(1e-3), Xavier init, 28x28x1 input. The builder puts a
`CnnToFeedForwardPreProcessor` before `ffn1`, which flattens in NCHW
order, so the JAX net's `ffn1` W rows are this net's. `conf()` equals
the JAX model's as a dict, and `init(seed)` draws its weights.

The packaged MNIST checkpoint (`lenet_mnist.zip`, written by the JAX
package's `tests/make_zoo_pretrained.py`: trained on sklearn's 8x8
digits upscaled to 28x28, 0.9764 on 297 held-out digits) restores
through `init_pretrained(PretrainedType.MNIST)` with its sha256
checked.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.common.updaters import Adam
from deeplearning4j_tpu_torch.common.weights import WeightInit
from deeplearning4j_tpu_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    ConvolutionLayer,
    DenseLayer,
    OutputLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.zoo.base import PretrainedType, ZooModel


class LeNet(ZooModel):
    packaged = {PretrainedType.MNIST: "lenet_mnist.zip"}

    def __init__(self, num_classes: int = 10, seed: int = 123,
                 height: int = 28, width: int = 28, channels: int = 1,
                 updater=None):
        super().__init__(num_classes=num_classes, seed=seed)
        self.height, self.width, self.channels = height, width, channels
        self.updater = updater or Adam(1e-3)

    def conf(self):
        return (NeuralNetConfiguration.builder()
                .seed(self.seed)
                .updater(self.updater)
                .weight_init(WeightInit.XAVIER)
                .list()
                .layer(ConvolutionLayer(n_out=20, kernel_size=(5, 5),
                                        stride=(1, 1), activation="relu",
                                        name="cnn1"))
                .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2),
                                        name="maxpool1"))
                .layer(ConvolutionLayer(n_out=50, kernel_size=(5, 5),
                                        stride=(1, 1), activation="relu",
                                        name="cnn2"))
                .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2),
                                        name="maxpool2"))
                .layer(DenseLayer(n_out=500, activation="relu", name="ffn1"))
                .layer(OutputLayer(n_out=self.num_classes,
                                   activation="softmax", loss="mcxent",
                                   name="output"))
                .set_input_type(InputType.convolutional(
                    self.height, self.width, self.channels))
                .build())
