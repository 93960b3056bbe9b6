"""Variational autoencoder (counterpart of
`deeplearning4j_tpu/nn/layers/variational.py`: the reconstruction
distributions :38-142, `VariationalAutoencoder` :145-273).

Params, in JAX's names: encoder "e{j}W"/"e{j}b", the q(z|x) heads
"pZXMeanW"/"pZXMeanb" and "pZXLogStd2W"/"pZXLogStd2b", decoder
"d{j}W"/"d{j}b", and the reconstruction "pXZW"/"pXZb"; dense layer i
in that order draws its W under ``fold_in(key, i)``, its b is zero.
`pzx_activation` applies to both heads. `forward` returns the q(z|x)
mean; `pretrain_loss` is the negative ELBO, the analytic KL plus the
reconstruction log-probability averaged over `num_samples` draws
``z = mean + exp(log_var / 2) * eps``, eps normal under ``fold_in(key,
s)``. The reconstruction distribution round-trips as a ``{"kind": ...,
"activation": ...}`` dict.
"""

from __future__ import annotations

import math

import torch

from deeplearning4j_tpu_torch.common import prng
from deeplearning4j_tpu_torch.common.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import (
    Layer,
    init_weight_,
    new_param,
    register_layer,
)

_RECON_REGISTRY = {}


def register_recon(cls):
    _RECON_REGISTRY[cls.kind] = cls
    return cls


class ReconstructionDistribution:
    """p(x|z): `log_prob` sums log p(x|z) over the features (-> [B])."""

    kind = "base"

    def __init__(self, activation=None):
        self.activation = get_activation(activation or self.DEFAULT)

    def to_dict(self):
        return {"kind": self.kind, "activation": self.activation.name}

    def __eq__(self, other):
        return type(self) is type(other) and self.to_dict() == other.to_dict()


def recon_from_dict(d):
    d = dict(d)
    return _RECON_REGISTRY[d.pop("kind")](**d)


@register_recon
class GaussianReconstructionDistribution(ReconstructionDistribution):
    """N(mean, exp(log_var)) per feature: 2 * n_in params, the mean
    through the activation."""

    kind = "gaussian"
    DEFAULT = "identity"

    def n_dist_params(self, data_size):
        return 2 * data_size

    def _split(self, dist_params):
        n = dist_params.shape[-1] // 2
        return self.activation(dist_params[..., :n]), dist_params[..., n:]

    def log_prob(self, x, dist_params):
        mean, log_var = self._split(dist_params)
        log2pi = torch.log(torch.tensor(2.0 * math.pi, dtype=x.dtype,
                                        device=x.device))
        ll = -0.5 * (log2pi + log_var + (x - mean) ** 2 / torch.exp(log_var))
        return ll.sum(dim=-1)

    def sample_mean(self, dist_params):
        return self._split(dist_params)[0]


@register_recon
class BernoulliReconstructionDistribution(ReconstructionDistribution):
    """Bernoulli(p), p the activation (sigmoid) clipped to [1e-7, 1 -
    1e-7]."""

    kind = "bernoulli"
    DEFAULT = "sigmoid"

    def n_dist_params(self, data_size):
        return data_size

    def log_prob(self, x, dist_params):
        p = self.activation(dist_params).clamp(1e-7, 1.0 - 1e-7)
        return (x * torch.log(p) + (1.0 - x) * torch.log1p(-p)).sum(dim=-1)

    def sample_mean(self, dist_params):
        return self.activation(dist_params)


@register_recon
class ExponentialReconstructionDistribution(ReconstructionDistribution):
    """Exp(lambda = exp(gamma)), gamma the activation."""

    kind = "exponential"
    DEFAULT = "identity"

    def n_dist_params(self, data_size):
        return data_size

    def log_prob(self, x, dist_params):
        gamma = self.activation(dist_params)
        return (gamma - torch.exp(gamma) * x).sum(dim=-1)

    def sample_mean(self, dist_params):
        return torch.exp(-self.activation(dist_params))


@register_layer
class VariationalAutoencoder(Layer):
    layer_name = "vae"
    FIELDS = (("n_in", 0), ("n_out", 0), ("encoder_layer_sizes", (100,)),
              ("decoder_layer_sizes", (100,)),
              ("reconstruction_distribution", None),
              ("pzx_activation", "identity"), ("num_samples", 1))
    DEFAULT_ACTIVATION = "relu"      # the encoder's and decoder's hidden

    def __init__(self, **config):
        super().__init__(**config)
        rd = self.reconstruction_distribution
        if rd is None:
            rd = GaussianReconstructionDistribution()
        elif isinstance(rd, dict):
            rd = recon_from_dict(rd)
        self.reconstruction_distribution = rd
        self.pzx_activation = get_activation(self.pzx_activation)
        self.encoder_layer_sizes = tuple(int(s) for s in
                                         self.encoder_layer_sizes)
        self.decoder_layer_sizes = tuple(int(s) for s in
                                         self.decoder_layer_sizes)
        self._build()

    def to_dict(self):
        d = super().to_dict()
        d["reconstruction_distribution"] = \
            self.reconstruction_distribution.to_dict()
        d["pzx_activation"] = self.pzx_activation.name
        return d

    def _dense_shapes(self):
        """[(name, n_in, n_out)] of the dense layers, in the init's fold
        order."""
        out, last = [], self.n_in
        for j, sz in enumerate(self.encoder_layer_sizes):
            out.append((f"e{j}", last, sz))
            last = sz
        out += [("pZXMean", last, self.n_out), ("pZXLogStd2", last,
                                                self.n_out)]
        last = self.n_out
        for j, sz in enumerate(self.decoder_layer_sizes):
            out.append((f"d{j}", last, sz))
            last = sz
        out.append(("pXZ", last,
                    self.reconstruction_distribution.n_dist_params(
                        self.n_in)))
        return out

    def _build(self):
        self.n_in, self.n_out = int(self.n_in), int(self.n_out)
        if not (self.n_in and self.n_out) or getattr(
                self, "pXZW", None) is not None:
            return
        for name, a, b in self._dense_shapes():
            setattr(self, name + "W", new_param((a, b), "cpu"))
            setattr(self, name + "b", new_param((b,), "cpu"))

    def set_n_in(self, input_type, override=True):
        if override or not self.n_in:
            self.n_in = input_type.arity()
        self._build()

    def get_output_type(self, input_type):
        return InputType.feed_forward(self.n_out)

    def jax_param_map(self):
        if getattr(self, "pXZW", None) is None:
            return {}
        return {name + s: getattr(self, name + s)
                for name, _, _ in self._dense_shapes() for s in ("W", "b")}

    def init_weights(self, key):
        for i, (name, _, _) in enumerate(self._dense_shapes()):
            init_weight_(self, getattr(self, name + "W"),
                         prng.fold_in(key, i))
            with torch.no_grad():
                getattr(self, name + "b").zero_()

    def _dense(self, name, h):
        return h @ getattr(self, name + "W") + getattr(self, name + "b")

    def encode(self, x):
        """(mean, log_var) of q(z|x)."""
        h = x
        for j in range(len(self.encoder_layer_sizes)):
            h = self.activation(self._dense(f"e{j}", h))
        return (self.pzx_activation(self._dense("pZXMean", h)),
                self.pzx_activation(self._dense("pZXLogStd2", h)))

    def decode(self, z):
        """The reconstruction distribution's params given z."""
        h = z
        for j in range(len(self.decoder_layer_sizes)):
            h = self.activation(self._dense(f"d{j}", h))
        return self._dense("pXZ", h)

    def forward(self, x, *, train=False, rng=None, mask=None):
        return self.encode(self.apply_input_dropout(x, train, rng))[0]

    def _log_prob_samples(self, x, mean, log_var, key, n):
        total = 0.0
        for s in range(n):
            eps = prng.normal(prng.fold_in(key, s), mean.shape, mean.dtype,
                              mean.device)
            z = mean + torch.exp(0.5 * log_var) * eps
            total = total + self.reconstruction_distribution.log_prob(
                x, self.decode(z))
        return total / n

    def pretrain_loss(self, x, rng):
        """The negative ELBO under the threefry key `rng` (PRNGKey(0)
        when None), averaged over the batch."""
        mean, log_var = self.encode(x)
        kl = 0.5 * (torch.exp(log_var) + mean ** 2 - 1.0 - log_var).sum(-1)
        rec = self._log_prob_samples(x, mean, log_var,
                                     rng if rng is not None else prng.key(0),
                                     self.num_samples)
        return (kl - rec).mean()

    @torch.no_grad()
    def reconstruction_probability(self, x, rng, num_samples=None):
        """The Monte-Carlo estimate of log p(x) per example (anomaly
        scoring) over `num_samples` draws under the key `rng`."""
        mean, log_var = self.encode(x)
        return self._log_prob_samples(x, mean, log_var, rng,
                                      num_samples or self.num_samples)

    @torch.no_grad()
    def generate_at_mean_given_z(self, z):
        return self.reconstruction_distribution.sample_mean(self.decode(z))
