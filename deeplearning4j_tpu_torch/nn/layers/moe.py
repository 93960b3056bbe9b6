"""Mixture of experts (counterpart of `deeplearning4j_tpu/nn/layers/moe.py`):
a router softmax over E experts, top-k gates renormalised, and every
expert's FFN applied to every token (dense dispatch: one einsum over the
stacked expert params, no capacity or overflow logic), combined by the
gates.

Params: router "Wg" [F, E]; experts "We1" [E, F, H], "be1" [E, H],
"We2" [E, H, O], "be2" [E, O]. Expert e's weights are drawn under
``fold_in(split(key, 3)[1 or 2], e)``, as JAX draws them.

The gates are JAX's sort-based top-k, not `torch.topk`: every expert
whose probability is at least the k-th largest keeps its gate, so a tie
at the k-th place selects more than k experts. The softmax is JAX's
(``exp(x - max)`` rounded in the compute dtype, its sum in fp32 rounded
back, then the divide), so bf16 gates round as JAX's do.

In training the forward leaves the Switch-style load-balance loss,
``load_balance_coef * E * sum_e frac_e * mean_prob_e`` (frac_e: the share
of tokens whose gate e is non-zero, no gradient), in its `new_state`
dict under "aux_loss"; the containers' losses pop it into the objective,
so it never persists and `score()`/`output()` never see it. MoE layers
never join a packed run (`stackable_params`).
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.common import prng
from deeplearning4j_tpu_torch.nn.conf.inputs import (
    InputType,
    InputTypeRecurrent,
)
from deeplearning4j_tpu_torch.nn.layers.base import (
    Layer,
    init_weight_,
    new_param,
    register_layer,
)


def jax_softmax(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softmax(x, axis=-1)` with JAX's roundings: the shifted
    exponent in x's dtype, the sum in fp32 rounded to x's dtype, the
    divide in x's dtype."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True, dtype=torch.float32).to(x.dtype)


@register_layer
class MixtureOfExperts(Layer):
    layer_name = "mixture_of_experts"
    FIELDS = (("n_in", 0), ("n_out", 0), ("n_experts", 4),
              ("hidden_size", 0), ("top_k", 2), ("load_balance_coef", 0.01))
    DEFAULT_ACTIVATION = "relu"      # the experts' hidden activation
    stackable_params = False
    emits_aux_loss = True

    def __init__(self, **config):
        super().__init__(**config)
        self._build()

    def _build(self):
        self.n_in, self.n_out = int(self.n_in), int(self.n_out)
        E, F, H, O = (int(self.n_experts), self.n_in, int(self.hidden_size),
                      self.n_out)
        self.n_experts, self.hidden_size = E, H
        Wg = getattr(self, "Wg", None)
        if not (F and H and O) or (Wg is not None
                                   and tuple(Wg.shape) == (F, E)):
            return
        self.Wg = new_param((F, E), "cpu")
        self.We1 = new_param((E, F, H), "cpu")
        self.be1 = new_param((E, H), "cpu")
        self.We2 = new_param((E, H, O), "cpu")
        self.be2 = new_param((E, O), "cpu")

    def set_n_in(self, input_type, override=True):
        size = (input_type.size if isinstance(input_type, InputTypeRecurrent)
                else input_type.arity())
        if override or not self.n_in:
            self.n_in = size
        if not self.n_out:
            self.n_out = self.n_in
        if not self.hidden_size:
            self.hidden_size = 4 * self.n_in
        self._build()

    def get_output_type(self, input_type):
        if isinstance(input_type, InputTypeRecurrent):
            return InputType.recurrent(self.n_out, input_type.timesteps)
        return InputType.feed_forward(self.n_out)

    def jax_param_map(self):
        if getattr(self, "Wg", None) is None:
            return {}
        return {"Wg": self.Wg, "We1": self.We1, "be1": self.be1,
                "We2": self.We2, "be2": self.be2}

    def init_weights(self, key):
        ks = prng.split(key, 3)
        init_weight_(self, self.Wg, ks[0])
        for e in range(self.n_experts):
            init_weight_(self, self.We1[e], prng.fold_in(ks[1], e))
            init_weight_(self, self.We2[e], prng.fold_in(ks[2], e))
        with torch.no_grad():
            self.be1.zero_()
            self.be2.zero_()

    def gate(self, x):
        """(gates [..., E], the load-balance loss before its coefficient):
        the JAX `_gate` (:87-101)."""
        E = self.n_experts
        probs = jax_softmax(x @ self.Wg)
        if self.top_k < E:
            kth = probs.sort(dim=-1).values[..., E - self.top_k, None]
            gates = torch.where(probs >= kth, probs, torch.zeros_like(probs))
            total = gates.sum(dim=-1, keepdim=True, dtype=torch.float32)
            gates = gates / total.to(gates.dtype).clamp(min=1e-9)
        else:
            gates = probs
        frac = (gates.reshape(-1, E) > 0).to(x.dtype).mean(dim=0)
        mean_prob = probs.reshape(-1, E).mean(dim=0)
        return gates, E * (frac * mean_prob).sum()

    def forward(self, x, *, train=False, rng=None, mask=None,
                new_state=None):
        x = self.apply_input_dropout(x, train, rng)
        gates, aux = self.gate(x)
        h = self.activation(torch.einsum("...f,efh->...eh", x, self.We1)
                            + self.be1)
        y = torch.einsum("...eh,eho->...eo", h, self.We2) + self.be2
        out = torch.einsum("...eo,...e->...o", y, gates)
        if train and self.load_balance_coef and new_state is not None:
            new_state["aux_loss"] = self.load_balance_coef * aux
        return out
