"""LayerNormalization (counterpart of
`deeplearning4j_tpu/nn/layers/normalization.py:121-176`)."""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.kernels.layernorm import layer_norm
from deeplearning4j_tpu_torch.nn.conf.inputs import InputTypeConvolutional
from deeplearning4j_tpu_torch.nn.layers.base import (
    Layer,
    new_param,
    register_layer,
)


@register_layer
class LayerNormalization(Layer):
    """Layer norm over the last axis with gamma/beta, through the
    LayerNorm autograd function (`kernels/layernorm.py`): the CUDA
    forward kernel on the card, its plain version on the CPU, and the
    analytic backward from the saved statistics."""

    layer_name = "layernorm"
    FIELDS = (("n_out", 0), ("eps", 1e-5))
    DEFAULT_ACTIVATION = "identity"

    def __init__(self, n_out: int = 0, eps: float = 1e-5, **config):
        super().__init__(n_out=n_out, eps=eps, **config)
        self._build()

    def _build(self):
        self.n_out = int(self.n_out)
        g = getattr(self, "gamma", None)
        if not self.n_out or (g is not None and g.shape[0] == self.n_out):
            return
        self.gamma = new_param((self.n_out,), "cpu")
        self.beta = new_param((self.n_out,), "cpu")
        with torch.no_grad():
            self.gamma.fill_(1.0)

    def set_n_in(self, input_type, override=True):
        if override or not self.n_out:
            if isinstance(input_type, InputTypeConvolutional):
                self.n_out = input_type.channels
            else:
                self.n_out = (input_type.size if hasattr(input_type, "size")
                              else input_type.arity())
        self._build()

    def jax_param_map(self):
        return {"gamma": self.gamma, "beta": self.beta}

    def forward(self, x):
        return self.activation(layer_norm(x.contiguous(), self.gamma,
                                          self.beta, float(self.eps)))


def layer_norm_reference(x, gamma, beta, eps):
    """The JAX package's plain layer norm: fp32 row statistics with the
    POPULATION variance (`jnp.var`; torch.var defaults to correction=1),
    division by sqrt(var + eps), the normalised value back in x.dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    y = ((x32 - mean) / torch.sqrt(var + eps)).to(x.dtype)
    return y * gamma + beta
