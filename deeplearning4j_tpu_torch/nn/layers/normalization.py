"""LayerNormalization (counterpart of
`deeplearning4j_tpu/nn/layers/normalization.py:121-176`)."""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.kernels.layernorm import layer_norm
from deeplearning4j_tpu_torch.nn.layers.base import Layer, new_param


class LayerNormalization(Layer):
    """Layer norm over the last axis with gamma/beta, through the
    LayerNorm autograd function (`kernels/layernorm.py`): the CUDA
    forward kernel on the card, its plain version on the CPU, and the
    analytic backward from the saved statistics."""

    def __init__(self, n_out: int, eps: float = 1e-5):
        super().__init__()
        self.n_out, self.eps = int(n_out), float(eps)
        self.gamma = new_param((self.n_out,), "cpu")
        self.beta = new_param((self.n_out,), "cpu")
        with torch.no_grad():
            self.gamma.fill_(1.0)

    def jax_param_map(self):
        return {"gamma": self.gamma, "beta": self.beta}

    def forward(self, x):
        return layer_norm(x.contiguous(), self.gamma, self.beta, self.eps)


def layer_norm_reference(x, gamma, beta, eps):
    """The JAX package's plain layer norm: fp32 row statistics with the
    POPULATION variance (`jnp.var`; torch.var defaults to correction=1),
    division by sqrt(var + eps), the normalised value back in x.dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    y = ((x32 - mean) / torch.sqrt(var + eps)).to(x.dtype)
    return y * gamma + beta
