"""BatchNormalization, LocalResponseNormalization and LayerNormalization
(counterpart of `deeplearning4j_tpu/nn/layers/normalization.py`:
`BatchNormalization` :28-91, `LocalResponseNormalization` :94-118,
`LayerNormalization` :121-176)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.common import global_batch
from deeplearning4j_tpu_torch.kernels.layernorm import layer_norm
from deeplearning4j_tpu_torch.nd import quant
from deeplearning4j_tpu_torch.nn.conf.inputs import InputTypeConvolutional
from deeplearning4j_tpu_torch.nn.layers.base import (
    Layer,
    new_param,
    register_layer,
)


@register_layer
class BatchNormalization(Layer):
    """Batch norm over every axis but the last (the features: [B, F],
    [B, T, F] and NHWC alike), with gamma/beta params (none when
    `lock_gamma_beta`) and the running `mean`/`var` as buffers, the JAX
    layer's `net_state`.

    Training normalizes with the batch statistics, which are computed in
    fp32 whatever the activation dtype, the variance the POPULATION one
    (`torch.var` defaults to correction=1). `forward` writes the running
    update ``decay * old + (1 - decay) * batch`` into `new_state`; the
    container stores it once the step's update is done, so a step that
    runs the forward twice updates once. Inference normalizes with the
    stored statistics. `F.batch_norm` (cuDNN's or PyTorch's kernel, the
    library counterpart of JAX's XLA fusion) computes the normalization
    from its input and the fp32 gamma/beta; it is never handed the
    running buffers, which it would update with the unbiased variance
    and `momentum = 1 - decay`. That is the fp32 path. Under a mixed
    policy (bf16 activations) the layer computes what JAX computes, in
    JAX's order and dtype (:67-88): fp32 statistics of the fp32 view
    (the batch's in training, the running ones at inference), ``inv =
    1 / sqrt(var + eps)`` in fp32, then ``(x - mean.bf16) * inv.bf16``
    and ``* gamma.bf16 + beta.bf16``, each product and sum rounded to
    bf16 (`_normalize_rounded`, plain PyTorch elementwise ops)."""

    layer_name = "batchnorm"
    FIELDS = (("n_out", 0), ("decay", 0.9), ("eps", 1e-5),
              ("gamma_init", 1.0), ("beta_init", 0.0),
              ("lock_gamma_beta", False))
    DEFAULT_ACTIVATION = "identity"

    def __init__(self, **config):
        super().__init__(**config)
        self._build()

    def _build(self):
        self.n_out = int(self.n_out)
        m = getattr(self, "mean", None)
        if not self.n_out or (m is not None and m.shape[0] == self.n_out):
            return
        self.register_buffer("mean", torch.zeros(self.n_out))
        self.register_buffer("var", torch.ones(self.n_out))
        if self.lock_gamma_beta:
            self.gamma = self.beta = None
            return
        self.gamma = new_param((self.n_out,), "cpu")
        self.beta = new_param((self.n_out,), "cpu")
        self.init_weights(None)

    def set_n_in(self, input_type, override=True):
        if override or not self.n_out:
            if isinstance(input_type, InputTypeConvolutional):
                self.n_out = input_type.channels
            else:
                self.n_out = (input_type.size if hasattr(input_type, "size")
                              else input_type.arity())
        self._build()

    def jax_param_map(self):
        if self.lock_gamma_beta or getattr(self, "gamma", None) is None:
            return {}
        return {"gamma": self.gamma, "beta": self.beta}

    def state_map(self):
        if getattr(self, "mean", None) is None:
            return {}
        return {"mean": self.mean, "var": self.var}

    @torch.no_grad()
    def init_weights(self, key):
        """gamma/beta from their init values, and a fresh running state
        (mean 0, var 1), as the JAX `init_params` and `init_state`."""
        self.mean.zero_()
        self.var.fill_(1.0)
        if not self.lock_gamma_beta:
            self.gamma.fill_(self.gamma_init)
            self.beta.fill_(self.beta_init)

    def forward(self, x, *, train=False, rng=None, mask=None,
                new_state=None):
        dims = tuple(range(x.ndim - 1))
        gamma = beta = None
        if not self.lock_gamma_beta:
            gamma = quant.weight(self, "gamma")
            beta = quant.weight(self, "beta")
        stats = {}
        rows = global_batch.current() if train else None
        if rows is not None and rows.xp is not None:
            y = self._normalize_global(x, gamma, beta, dims, rows, stats)
        elif x.dtype == torch.float32:
            y = self._normalize_library(x, train, gamma, beta)
        else:
            y = self._normalize_rounded(x, train, gamma, beta, dims, stats)
        if train and new_state is not None:
            with torch.no_grad():
                if stats:
                    mean, var = stats["mean"], stats["var"]
                else:
                    var, mean = torch.var_mean(x.float(), dim=dims,
                                               correction=0)
                d = self.decay
                new_state["mean"] = d * self.mean + (1 - d) * mean
                new_state["var"] = d * self.var + (1 - d) * var
        return self.activation(y)

    def _normalize_library(self, x, train, gamma, beta):
        """`F.batch_norm` with fp32 gamma/beta: channels to axis 1 (NHWC
        -> channels_last NCHW, [B, T, F] -> [B, F, T], views)."""
        if gamma is not None:
            gamma, beta = gamma.float(), beta.float()
        xc = x.movedim(-1, 1) if x.ndim > 2 else x
        y = F.batch_norm(xc, None if train else self.mean,
                         None if train else self.var, gamma, beta,
                         training=train, eps=float(self.eps))
        return y.movedim(1, -1) if x.ndim > 2 else y

    def _normalize_global(self, x, gamma, beta, dims, rows, stats):
        """Training on rows of a global batch that other processes
        share (`common.global_batch`): the global batch's fp32
        statistics, then JAX's normalization in x's dtype."""
        mean, var = global_batch.mean_var(x, dims, rows)
        stats.update(mean=mean.detach(), var=var.detach())
        inv = 1.0 / torch.sqrt(var + self.eps)
        y = (x - mean.to(x.dtype)) * inv.to(x.dtype)
        if gamma is not None:
            y = y * gamma.to(x.dtype) + beta.to(x.dtype)
        return y

    def _normalize_rounded(self, x, train, gamma, beta, dims, stats=None):
        """JAX's normalization in x's dtype: the fp32 statistics (a
        two-pass mean and population variance of the fp32 view, as
        `jnp.var` takes it, differentiated through in training, and left
        detached in `stats` for the running state), the fp32 inverse
        deviation, then every elementwise step in x's dtype."""
        if train:
            mean = x.mean(dim=dims, dtype=torch.float32)
            var = (x.float() - mean).square().mean(dim=dims)
            if stats is not None:
                stats.update(mean=mean.detach(), var=var.detach())
        else:
            mean, var = self.mean, self.var
        inv = 1.0 / torch.sqrt(var + self.eps)
        y = (x - mean.to(x.dtype)) * inv.to(x.dtype)
        if gamma is not None:
            y = y * gamma.to(x.dtype) + beta.to(x.dtype)
        return y


@register_layer
class LocalResponseNormalization(Layer):
    """Across-channel LRN (AlexNet's, GoogLeNet's and FaceNet's) over the
    last axis of NHWC: ``x / (k + alpha * win) ** beta``, `win` the sum
    of x^2 over the `n` channels centred on each one (zeros past the
    edges). JAX's own form, in x's dtype: the squares padded by n // 2
    on each side, their cumulative sum (a leading zero prepended) and
    the difference of two sums n apart. Under `mixed_bf16` both packages
    take that cumsum in bf16, each with its own rounding order, so the
    window carries a few bf16 ulps of the cumsum's scale, not of the
    window's; no params, plain PyTorch ops (the JAX layer is plain
    `jnp`)."""

    layer_name = "lrn"
    FIELDS = (("k", 2.0), ("n", 5), ("alpha", 1e-4), ("beta", 0.75))

    def forward(self, x, *, train=False, rng=None, mask=None):
        half = self.n // 2
        csum = torch.cumsum(F.pad(x * x, (half, half)), dim=-1)
        csum = F.pad(csum, (1, 0))
        win = csum[..., self.n:] - csum[..., :-self.n]
        return x / (self.k + self.alpha * win) ** self.beta


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

    def forward(self, x, *, train=False, rng=None, mask=None):
        return self.activation(layer_norm(
            x.contiguous(), quant.weight(self, "gamma"),
            quant.weight(self, "beta"), float(self.eps)))


def layer_norm_reference(x, gamma, beta, eps):
    """The JAX package's plain layer norm: fp32 row statistics with the
    POPULATION variance (`jnp.var`; torch.var defaults to correction=1),
    division by sqrt(var + eps), the normalised value back in x.dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    y = ((x32 - mean) / torch.sqrt(var + eps)).to(x.dtype)
    return y * gamma + beta
