"""The recurrent family (counterpart of
`deeplearning4j_tpu/nn/layers/recurrent.py`: `BaseRecurrentLayer` :48,
`LSTM` :67, `GravesLSTM` :183, `GravesBidirectionalLSTM` :193,
`SimpleRnn` :219, `RnnOutputLayer` :283, `LastTimeStep` :311).

Conventions are the JAX package's, so its params and configurations load
unchanged:
- gate order IFOG (input, forget, output, input-modulation) in the 4H
  columns of "W" [nIn, 4H], "RW" [H, 4H] and "b" [4H]; GravesLSTM adds
  the peepholes "pI" and "pF" (on the previous cell) and "pO" (on the
  new cell), each [H]; the bidirectional layer suffixes each direction's
  params with "F" and "B" and SUMS the two directions' outputs;
- "b" starts at zeros with the forget block [H, 2H) at
  `forget_gate_bias_init` (1.0); the gates take `gate_activation`
  (sigmoid) and the cell `activation` (tanh);
- masks: a masked step carries h and c through unchanged and emits
  zeros; the reverse direction starts at the padded tail and carries its
  state through the masked steps, as `lax.scan(reverse=True)` does.

Design: the input projection of every timestep is one [B*T, nIn] x
[nIn, 4H] matmul (JAX hoists it out of its scan the same way); the time
loop is a plain PyTorch loop over ``h @ RW`` and the gate elementwise
ops, which autograd differentiates step by step. cuDNN's `torch.nn.LSTM`
is not used: it has no peepholes, no configurable gate activation, and
packs its gates i, f, g, o. The loop issues some 15 kernel launches a
step and layer forward, about twice that backward (the launch count a
fused cell kernel would remove).

The carry API (`init_carry`, `forward_with_carry`) threads the state
through truncated BPTT and `rnn_time_step`: an LSTM's carry is (h, c),
the bidirectional one's ((h, c) forward, (h, c) backward), a SimpleRnn's
h, all in the compute dtype.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.common import prng
from deeplearning4j_tpu_torch.common.activations import get_activation
from deeplearning4j_tpu_torch.common.losses import get_loss
from deeplearning4j_tpu_torch.common.weights import init_weights
from deeplearning4j_tpu_torch.nd import quant
from deeplearning4j_tpu_torch.nn.conf.inputs import (
    InputType,
    InputTypeRecurrent,
)
from deeplearning4j_tpu_torch.nn.layers.base import (
    Layer,
    new_param,
    register_layer,
)
from deeplearning4j_tpu_torch.nn.layers.feedforward import (
    BaseOutputLayerMixin,
    DenseLayer,
)


class BaseRecurrentLayer(Layer):
    """Carry-based streaming API: `forward_with_carry(x, carry, mask=,
    train=, rng=)` -> (y, new_carry); `forward` runs from a fresh carry
    in x's dtype."""

    def init_carry(self, batch: int, dtype, device):
        raise NotImplementedError

    def forward_with_carry(self, x, carry, mask=None, *, train=False,
                           rng=None):
        raise NotImplementedError

    def forward(self, x, *, train=False, rng=None, mask=None):
        carry = self.init_carry(x.shape[0], x.dtype, x.device)
        return self.forward_with_carry(x, carry, mask, train=train,
                                       rng=rng)[0]


def _recurrent_n_in(layer, input_type, override):
    if not isinstance(input_type, InputTypeRecurrent):
        raise ValueError(f"{type(layer).__name__} expects recurrent input, "
                         f"got {input_type}")
    if override or not layer.n_in:
        layer.n_in = input_type.size


def _step_mask(mask, t):
    """[B, 1] bool: step t is real."""
    return None if mask is None else (mask[:, t, None] > 0)


@register_layer
class LSTM(BaseRecurrentLayer):
    """The no-peephole LSTM (JAX :67)."""

    layer_name = "lstm"
    FIELDS = (("n_in", 0), ("n_out", 0), ("forget_gate_bias_init", 1.0),
              ("gate_activation", "sigmoid"))
    DEFAULT_ACTIVATION = "tanh"
    peephole = False
    suffixes = ("",)

    def __init__(self, n_in: int = 0, n_out: int = 0, **config):
        super().__init__(n_in=n_in, n_out=n_out, **config)
        self.gate_activation = get_activation(self.gate_activation)
        self._build()

    def _names(self, suffix):
        names = ["W", "RW", "b"] + (["pI", "pF", "pO"] if self.peephole
                                    else [])
        return [n + suffix for n in names]

    def _shape(self, name):
        H = self.n_out
        return {"W": (self.n_in, 4 * H), "RW": (H, 4 * H),
                "b": (4 * H,)}.get(name, (H,))

    def _build(self):
        self.n_in, self.n_out = int(self.n_in), int(self.n_out)
        if not (self.n_in and self.n_out):
            return
        for suffix in self.suffixes:
            for name in self._names(suffix):
                shape = self._shape(name[:-len(suffix)] if suffix else name)
                t = getattr(self, name, None)
                if t is None or tuple(t.shape) != shape:
                    setattr(self, name, new_param(shape, "cpu"))

    def set_n_in(self, input_type, override=True):
        _recurrent_n_in(self, input_type, override)
        self._build()

    def get_output_type(self, input_type):
        return InputType.recurrent(self.n_out,
                                   getattr(input_type, "timesteps", None))

    def jax_param_map(self):
        if getattr(self, "W" + self.suffixes[0], None) is None:
            return {}
        return {n: getattr(self, n) for s in self.suffixes
                for n in self._names(s)}

    @torch.no_grad()
    def _init_direction(self, key, suffix):
        """The JAX `_direction_params`: W and RW under the two halves of
        `split(key)`, b zeros with the forget block at
        `forget_gate_bias_init`, the peepholes zeros."""
        k1, k2 = prng.split(key)
        H = self.n_out
        for name, k, fan_in in (("W", k1, self.n_in), ("RW", k2, H)):
            t = getattr(self, name + suffix)
            t.copy_(init_weights(k, t.shape, self.weight_init, fan_in=fan_in,
                                 fan_out=4 * H, distribution=self.dist,
                                 dtype=t.dtype, device=t.device))
        b = getattr(self, "b" + suffix)
        b.zero_()
        b[H:2 * H] = self.forget_gate_bias_init
        if self.peephole:
            for name in ("pI", "pF", "pO"):
                getattr(self, name + suffix).zero_()

    def init_weights(self, key):
        self._init_direction(key, "")

    def init_carry(self, batch, dtype, device):
        z = torch.zeros((batch, self.n_out), dtype=dtype, device=device)
        return (z, z.clone())

    def _scan(self, x, carry, mask, reverse=False, suffix=""):
        """One direction over x [B, T, nIn] from carry (h, c): the hoisted
        input projection, then the per-step cell. Returns (y [B, T, H],
        (h, c))."""
        W = lambda n: quant.weight(self, n + suffix).to(x.dtype)  # noqa: E731
        B, T, H = x.shape[0], x.shape[1], self.n_out
        xz = (x.reshape(-1, x.shape[-1]) @ W("W")).reshape(B, T, 4 * H) \
            + W("b")
        rw = W("RW")
        gate, act = self.gate_activation, self.activation
        if self.peephole:
            p_i, p_f, p_o = W("pI"), W("pF"), W("pO")
        h, c = carry
        outs = [None] * T
        for t in (range(T - 1, -1, -1) if reverse else range(T)):
            z = xz[:, t] + h @ rw
            zi, zf, zo, zg = z.split(H, dim=-1)
            if self.peephole:
                zi = zi + p_i * c
                zf = zf + p_f * c
            c_new = gate(zf) * c + gate(zi) * act(zg)
            if self.peephole:
                zo = zo + p_o * c_new
            h_new = gate(zo) * act(c_new)
            m = _step_mask(mask, t)
            if m is None:
                h, c = h_new, c_new
                outs[t] = h
            else:
                h = torch.where(m, h_new, h)
                c = torch.where(m, c_new, c)
                outs[t] = torch.where(m, h, torch.zeros_like(h))
        return torch.stack(outs, dim=1), (h, c)

    def forward_with_carry(self, x, carry, mask=None, *, train=False,
                           rng=None):
        x = self.apply_input_dropout(x, train, rng)
        return self._scan(x, carry, mask)


@register_layer
class GravesLSTM(LSTM):
    """LSTM with peepholes (JAX :183)."""

    layer_name = "graves_lstm"
    peephole = True


@register_layer
class GravesBidirectionalLSTM(LSTM):
    """Peephole LSTM both ways, the outputs summed (JAX :193): params
    suffixed "F" and "B", each direction drawn under its half of
    `split(key)`."""

    layer_name = "graves_bidirectional_lstm"
    peephole = True
    suffixes = ("F", "B")

    def init_weights(self, key):
        kf, kb = prng.split(key)
        self._init_direction(kf, "F")
        self._init_direction(kb, "B")

    def init_carry(self, batch, dtype, device):
        return (super().init_carry(batch, dtype, device),
                super().init_carry(batch, dtype, device))

    def forward_with_carry(self, x, carry, mask=None, *, train=False,
                           rng=None):
        x = self.apply_input_dropout(x, train, rng)
        yf, cf = self._scan(x, carry[0], mask, suffix="F")
        yb, cb = self._scan(x, carry[1], mask, reverse=True, suffix="B")
        return yf + yb, (cf, cb)


@register_layer
class SimpleRnn(BaseRecurrentLayer):
    """Elman RNN, h_t = act(x_t W + b + h_{t-1} RW) (JAX :219)."""

    layer_name = "simple_rnn"
    FIELDS = (("n_in", 0), ("n_out", 0))
    DEFAULT_ACTIVATION = "tanh"

    def __init__(self, n_in: int = 0, n_out: int = 0, **config):
        super().__init__(n_in=n_in, n_out=n_out, **config)
        self._build()

    def _build(self):
        self.n_in, self.n_out = int(self.n_in), int(self.n_out)
        W = getattr(self, "W", None)
        if not (self.n_in and self.n_out) or (
                W is not None and tuple(W.shape) == (self.n_in, self.n_out)):
            return
        self.W = new_param((self.n_in, self.n_out), "cpu")
        self.RW = new_param((self.n_out, self.n_out), "cpu")
        self.b = new_param((self.n_out,), "cpu")

    def set_n_in(self, input_type, override=True):
        if override or not self.n_in:
            self.n_in = input_type.size
        self._build()

    def get_output_type(self, input_type):
        return InputType.recurrent(self.n_out,
                                   getattr(input_type, "timesteps", None))

    def jax_param_map(self):
        if getattr(self, "W", None) is None:
            return {}
        return {"W": self.W, "RW": self.RW, "b": self.b}

    @torch.no_grad()
    def init_weights(self, key):
        k1, k2 = prng.split(key)
        for t, k in ((self.W, k1), (self.RW, k2)):
            t.copy_(init_weights(k, t.shape, self.weight_init,
                                 fan_in=t.shape[0], fan_out=self.n_out,
                                 distribution=self.dist, dtype=t.dtype,
                                 device=t.device))
        self.b.fill_(self.bias_init)

    def init_carry(self, batch, dtype, device):
        return torch.zeros((batch, self.n_out), dtype=dtype, device=device)

    def forward_with_carry(self, x, carry, mask=None, *, train=False,
                           rng=None):
        x = self.apply_input_dropout(x, train, rng)
        W = lambda n: quant.weight(self, n).to(x.dtype)  # noqa: E731
        B, T = x.shape[0], x.shape[1]
        xz = (x.reshape(-1, x.shape[-1]) @ W("W")).reshape(B, T, -1) + W("b")
        rw, act, h = W("RW"), self.activation, carry
        outs = []
        for t in range(T):
            h_new = act(xz[:, t] + h @ rw)
            m = _step_mask(mask, t)
            if m is None:
                h = h_new
                outs.append(h)
            else:
                h = torch.where(m, h_new, h)
                outs.append(torch.where(m, h, torch.zeros_like(h)))
        return torch.stack(outs, dim=1), h


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


@register_layer
class LastTimeStep(Layer):
    """[B, T, F] -> [B, F]: the last step, or with a mask each row's last
    real step (index ``max(sum(mask) - 1, 0)``, so an all-masked row
    takes step 0); the mask stops here (JAX :311)."""

    layer_name = "last_time_step"

    def get_output_type(self, input_type):
        return InputType.feed_forward(input_type.size)

    def forward(self, x, *, train=False, rng=None, mask=None):
        if mask is None:
            return x[:, -1, :]
        idx = (mask.to(torch.int64).sum(dim=1) - 1).clamp_min(0)
        return x[torch.arange(x.shape[0], device=x.device), idx]

    def forward_mask(self, mask):
        return None
