"""CenterLossOutputLayer (counterpart of
`deeplearning4j_tpu/nn/layers/training.py:31-58`): an `OutputLayer`
with one feature centre per class, the param `cL` [n_out, n_in]
(zeros at init), trained by autodiff as in JAX. The loss is the output
layer's plus ``0.5 * lambda_ * mean(||x - cL[argmax y]||^2)`` over the
rows, a masked row's term zeroed (the mean still counts it, as JAX's
does). `alpha` stays for the configuration's sake. `cL` takes no l1/l2
(`regularization_score` leaves it out) and crosses every carrier (the
zip, `util/jax_params`) under its JAX name."""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nd import quant
from deeplearning4j_tpu_torch.nn.layers.base import new_param, register_layer
from deeplearning4j_tpu_torch.nn.layers.feedforward import OutputLayer


@register_layer
class CenterLossOutputLayer(OutputLayer):
    layer_name = "center_loss_output"
    FIELDS = OutputLayer.FIELDS + (("alpha", 0.05), ("lambda_", 2e-4))

    def _build(self):
        super()._build()
        shape = (self.n_out, self.n_in)
        cL = getattr(self, "cL", None)
        if self.n_in and self.n_out and (cL is None
                                         or tuple(cL.shape) != shape):
            self.cL = new_param(shape, "cpu")

    def jax_param_map(self):
        params = super().jax_param_map()
        if params:
            params["cL"] = self.cL
        return params

    def init_weights(self, key):
        super().init_weights(key)
        with torch.no_grad():
            self.cL.zero_()

    def regularization_score(self, params):
        return super().regularization_score(
            {k: v for k, v in params.items() if k != "cL"})

    def compute_loss(self, x, labels, mask=None, *, train=False, rng=None):
        x = self.apply_input_dropout(x, train, rng)
        base = self.loss(labels, self.pre_output(x), self.activation,
                         mask=mask)
        c_y = quant.weight(self, "cL")[labels.argmax(dim=-1)]
        term = ((x - c_y) ** 2).sum(dim=-1)
        if mask is not None:
            m = (mask.reshape(mask.shape[0], -1).ne(0).any(dim=-1)
                 if mask.ndim > 1 else mask)
            term = term * m.to(x.dtype)
        return base + 0.5 * self.lambda_ * term.mean()
