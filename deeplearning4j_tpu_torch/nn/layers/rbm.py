"""Restricted Boltzmann machine (counterpart of
`deeplearning4j_tpu/nn/layers/rbm.py`).

Params "W" [n_in, n_out], hidden bias "b" and visible bias "vb" (both
zero at init). `forward` is ``activation(x W + b)``. CD-k pretraining
is a loss, as in JAX: the mean free-energy difference F(v0) - F(vk),
the negative particle vk Gibbs-sampled from the data (step s draws h
under ``fold_in(key, 2s)`` and v under ``fold_in(key, 2s + 1)``) with
its gradient stopped, plus the optional sparsity penalty. Binary units
sample ``uniform < mean`` with the uniforms JAX draws (`prng.bernoulli`
with a tensor p), so a mean within rounding of its uniform can flip
between two devices.
"""

from __future__ import annotations

from enum import Enum

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.common import prng
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import (
    Layer,
    init_weight_,
    new_param,
    register_layer,
)


class HiddenUnit(str, Enum):
    BINARY = "binary"
    RECTIFIED = "rectified"
    GAUSSIAN = "gaussian"


class VisibleUnit(str, Enum):
    BINARY = "binary"
    GAUSSIAN = "gaussian"


@register_layer
class RBM(Layer):
    layer_name = "rbm"
    FIELDS = (("n_in", 0), ("n_out", 0), ("hidden_unit", HiddenUnit.BINARY),
              ("visible_unit", VisibleUnit.BINARY), ("k", 1),
              ("sparsity", 0.0))
    DEFAULT_ACTIVATION = "sigmoid"

    def __init__(self, n_in: int = 0, n_out: int = 0, **config):
        super().__init__(n_in=n_in, n_out=n_out, **config)
        self.hidden_unit = HiddenUnit(self.hidden_unit)
        self.visible_unit = VisibleUnit(self.visible_unit)
        self._build()

    def _build(self):
        self.n_in, self.n_out = int(self.n_in), int(self.n_out)
        W = getattr(self, "W", None)
        if not (self.n_in and self.n_out) or (
                W is not None and tuple(W.shape) == (self.n_in, self.n_out)):
            return
        self.W = new_param((self.n_in, self.n_out), "cpu")
        self.b = new_param((self.n_out,), "cpu")
        self.vb = new_param((self.n_in,), "cpu")

    def set_n_in(self, input_type, override=True):
        if override or not self.n_in:
            self.n_in = input_type.arity()
        self._build()

    def get_output_type(self, input_type):
        return InputType.feed_forward(self.n_out)

    def jax_param_map(self):
        if getattr(self, "W", None) is None:
            return {}
        return {"W": self.W, "b": self.b, "vb": self.vb}

    def init_weights(self, key):
        init_weight_(self, self.W, key)
        with torch.no_grad():
            self.b.zero_()
            self.vb.zero_()

    # ------------------------------------------------------------ phases
    def prop_up(self, v):
        z = v @ self.W + self.b
        if self.hidden_unit == HiddenUnit.RECTIFIED:
            return torch.clamp(z, min=0.0)
        if self.hidden_unit == HiddenUnit.GAUSSIAN:
            return z
        return torch.sigmoid(z)

    def prop_down(self, h):
        z = h @ self.W.T + self.vb
        if self.visible_unit == VisibleUnit.GAUSSIAN:
            return z
        return torch.sigmoid(z)

    @staticmethod
    def _sample(key, mean, binary, gaussian, dtype):
        if binary:
            return prng.bernoulli(key, mean).to(dtype)
        if gaussian:
            return mean + prng.normal(key, mean.shape, mean.dtype,
                                      mean.device)
        return mean

    def sample_h(self, key, v):
        return self._sample(key, self.prop_up(v),
                            self.hidden_unit == HiddenUnit.BINARY,
                            self.hidden_unit == HiddenUnit.GAUSSIAN, v.dtype)

    def sample_v(self, key, h):
        return self._sample(key, self.prop_down(h),
                            self.visible_unit == VisibleUnit.BINARY,
                            self.visible_unit == VisibleUnit.GAUSSIAN,
                            h.dtype)

    def free_energy(self, v):
        """F(v) with the hidden units summed out: -softplus (binary),
        a quadratic term (gaussian; rectified over its positive part),
        and the visible term for the visible units."""
        z = v @ self.W + self.b
        if self.visible_unit == VisibleUnit.GAUSSIAN:
            vis = 0.5 * ((v - self.vb) ** 2).sum(dim=-1)
        else:
            vis = -(v @ self.vb)
        if self.hidden_unit == HiddenUnit.GAUSSIAN:
            hid = 0.5 * (z * z).sum(dim=-1)
        elif self.hidden_unit == HiddenUnit.RECTIFIED:
            hid = 0.5 * (torch.clamp(z, min=0.0) ** 2).sum(dim=-1)
        else:
            hid = F.softplus(z).sum(dim=-1)
        return vis - hid

    def gibbs_chain(self, x, key):
        """The negative particle v_k of CD-k from the data x."""
        v = x
        for step in range(int(self.k)):
            h = self.sample_h(prng.fold_in(key, 2 * step), v)
            v = self.sample_v(prng.fold_in(key, 2 * step + 1), h)
        return v

    def forward(self, x, *, train=False, rng=None, mask=None):
        x = self.apply_input_dropout(x, train, rng)
        return self.activation(x @ self.W + self.b)

    def pretrain_loss(self, x, rng):
        """The CD-k loss under the threefry key `rng` (PRNGKey(0) when
        None)."""
        v_neg = self.gibbs_chain(x, rng if rng is not None
                                 else prng.key(0)).detach()
        loss = (self.free_energy(x) - self.free_energy(v_neg)).mean()
        if self.sparsity:
            h_mean = self.prop_up(x).mean(dim=0)
            loss = loss + ((h_mean - self.sparsity) ** 2).sum()
        return loss
