"""Recurrent-layer base and the per-timestep output layer (counterpart of
`deeplearning4j_tpu/nn/layers/recurrent.py`: `BaseRecurrentLayer` :48,
`RnnOutputLayer` :283). The LSTM family is a later slice."""

from __future__ import annotations

from deeplearning4j_tpu_torch.common.losses import get_loss
from deeplearning4j_tpu_torch.nn.layers.base import Layer
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


class RnnOutputLayer(DenseLayer, BaseOutputLayerMixin):
    """Dense projection at every timestep, then the activation (softmax
    over the vocabulary for the LM); the loss (mcxent by default) takes
    the fused `log_softmax(preout)` path under softmax."""

    def __init__(self, n_in: int, n_out: int, *, activation="softmax",
                 loss="mcxent"):
        super().__init__(n_in, n_out, activation=activation)
        self.loss = get_loss(loss)
