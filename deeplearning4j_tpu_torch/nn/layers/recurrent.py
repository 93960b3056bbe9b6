"""Recurrent-layer base and the per-timestep output layer (counterpart of
`deeplearning4j_tpu/nn/layers/recurrent.py`: `BaseRecurrentLayer` :48,
`RnnOutputLayer` :283). The LSTM family is a later slice."""

from __future__ import annotations

from deeplearning4j_tpu_torch.common.losses import get_loss
from deeplearning4j_tpu_torch.nn.conf.inputs import (
    InputType,
    InputTypeRecurrent,
)
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer
from deeplearning4j_tpu_torch.nn.layers.feedforward import (
    BaseOutputLayerMixin,
    DenseLayer,
)


class BaseRecurrentLayer(Layer):
    """Carry-based streaming API: `forward_with_carry(x, carry)` ->
    (y, new_carry)."""

    def init_carry(self, batch: int, dtype, device):
        raise NotImplementedError

    def forward_with_carry(self, x, carry):
        raise NotImplementedError


@register_layer
class RnnOutputLayer(DenseLayer, BaseOutputLayerMixin):
    """Dense projection at every timestep, then the activation (softmax
    over the vocabulary for the LM); the loss (mcxent by default) takes
    the fused `log_softmax(preout)` path under softmax."""

    layer_name = "rnn_output"
    FIELDS = DenseLayer.FIELDS + (("loss", None),)
    DEFAULT_ACTIVATION = "softmax"

    def __init__(self, n_in: int = 0, n_out: int = 0, **config):
        super().__init__(n_in, n_out, **config)
        self.loss = get_loss(self.loss if self.loss is not None
                             else "mcxent")

    def set_n_in(self, input_type, override=True):
        if override or not self.n_in:
            self.n_in = (input_type.size
                         if isinstance(input_type, InputTypeRecurrent)
                         else input_type.arity())
        self._build()

    def get_output_type(self, input_type):
        return InputType.recurrent(self.n_out,
                                   getattr(input_type, "timesteps", None))
