"""Convolution, subsampling and zero padding (counterpart of
`deeplearning4j_tpu/nn/layers/convolution.py`: `ConvolutionMode` :39,
`_pair` :47, `conv_out_size` :53, `_explicit_padding` :66,
`ConvolutionLayer` :81-147, `SubsamplingLayer` :209-266,
`ZeroPaddingLayer` :322-353). The other layers of that module wait for
a later slice (ROADMAP Queue 1 item 9).

Layout: activations are NHWC, as in the JAX package. A layer hands
`F.conv2d` and the pooling ops `x.permute(0, 3, 1, 2)`, which for a
contiguous NHWC tensor is a `channels_last` NCHW view (no copy), and
permutes the channels_last result back to NHWC (no copy either).

The weight `W` has the JAX name and shape, HWIO [kh, kw, in, out], so
every carrier (the zip, `util/jax_params`, the updater state, weight
noise, constraints, `param_table`) indexes it as JAX does. Its memory is
laid out out-in-last (OHWI): `W.permute(3, 2, 0, 1)` is then the OIHW
weight in `channels_last` format that cuDNN takes without a copy. The
updater slots are made `zeros_like(W)` and share that layout.

Padding is JAX's: SAME pads `total // 2` before and the rest after, so
a stride-2 window can be padded unevenly (the 7x7/2 stem conv at 224
pads (2, 3), the 3x3/2 max pool at 112 (0, 1)). PyTorch's `padding=`
is symmetric: it is used only where the two sides agree, else the
input is padded with `F.pad` (-inf for MAX). AVG divides each window
by its count of real cells, as JAX's `reduce_window` of ones does.
The convolutions run on cuDNN and the pooling on PyTorch's own kernels:
both are XLA operations in the JAX package, not Pallas kernels.
"""

from __future__ import annotations

from enum import Enum
from typing import Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nd import quant
from deeplearning4j_tpu_torch.nn.conf.inputs import (
    InputType,
    InputTypeConvolutional,
)
from deeplearning4j_tpu_torch.nn.layers.base import (
    Layer,
    init_weight_,
    register_layer,
)


class ConvolutionMode(str, Enum):
    SAME = "same"
    TRUNCATE = "truncate"
    STRICT = "strict"


class PoolingMode(str, Enum):
    MAX = "max"
    AVG = "avg"
    SUM = "sum"
    PNORM = "pnorm"


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (list, tuple)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


def conv_out_size(size: int, kernel: int, stride: int, pad: int,
                  dilation: int, mode: ConvolutionMode) -> int:
    eff = kernel + (kernel - 1) * (dilation - 1)
    if mode == ConvolutionMode.SAME:
        return -(-size // stride)
    out = (size + 2 * pad - eff) // stride + 1
    if mode == ConvolutionMode.STRICT and (size + 2 * pad - eff) % stride:
        raise ValueError(
            f"ConvolutionMode.STRICT: size {size} with kernel {kernel}, "
            f"stride {stride}, pad {pad} does not divide evenly")
    return out


def _explicit_padding(mode, pad_hw, kernel_hw, dilation_hw, stride_hw,
                      in_hw):
    """[(before, after)] per spatial axis, as the JAX `_explicit_padding`
    gives it to `lax.conv` and `reduce_window`."""
    if mode == ConvolutionMode.SAME:
        pads = []
        for size, k, s, d in zip(in_hw, kernel_hw, stride_hw, dilation_hw):
            eff = k + (k - 1) * (d - 1)
            total = max(0, (-(-size // s) - 1) * s + eff - size)
            pads.append((total // 2, total - total // 2))
        return pads
    return [(p, p) for p in pad_hw]


def _symmetric(pads) -> bool:
    return all(a == b for a, b in pads)


def _pad_nhwc(x, pads, value=0.0):
    (t, b), (l, r) = pads
    return F.pad(x, (0, 0, l, r, t, b), value=value)


def _nchw(x):
    """The NHWC tensor as the channels_last NCHW view PyTorch's ops take."""
    return x.permute(0, 3, 1, 2)


def _nhwc(y):
    return y.permute(0, 2, 3, 1)


def conv_weight(kh: int, kw: int, n_in: int, n_out: int):
    """A zero HWIO weight [kh, kw, n_in, n_out] whose memory is OHWI, so
    its `.permute(3, 2, 0, 1)` is OIHW in channels_last format; it takes
    no gradient outside `fit`."""
    t = torch.zeros(n_out, kh, kw, n_in).permute(1, 2, 3, 0)
    return torch.nn.Parameter(t, requires_grad=False)


@register_layer
class ConvolutionLayer(Layer):
    """2-D convolution over NHWC input: W [kh, kw, in, out] (HWIO), an
    optional bias b [out], strides, dilation and the three padding
    modes; the activation after the bias (identity by default)."""

    layer_name = "convolution"
    FIELDS = (("n_in", 0), ("n_out", 0), ("kernel_size", (5, 5)),
              ("stride", (1, 1)), ("padding", (0, 0)), ("dilation", (1, 1)),
              ("convolution_mode", ConvolutionMode.TRUNCATE),
              ("has_bias", True))
    DEFAULT_ACTIVATION = "identity"

    def __init__(self, **config):
        super().__init__(**config)
        self.kernel_size = _pair(self.kernel_size)
        self.stride = _pair(self.stride)
        self.padding = _pair(self.padding)
        self.dilation = _pair(self.dilation)
        self.convolution_mode = ConvolutionMode(self.convolution_mode)
        self._build()

    def _build(self):
        self.n_in, self.n_out = int(self.n_in), int(self.n_out)
        shape = (*self.kernel_size, self.n_in, self.n_out)
        W = getattr(self, "W", None)
        if not (self.n_in and self.n_out) or (
                W is not None and tuple(W.shape) == shape):
            return
        self.W = conv_weight(*shape)
        self.b = (torch.nn.Parameter(torch.zeros(self.n_out),
                                     requires_grad=False)
                  if self.has_bias else None)

    def set_n_in(self, input_type, override=True):
        if not isinstance(input_type, InputTypeConvolutional):
            raise ValueError(f"ConvolutionLayer expects convolutional "
                             f"input, got {input_type}")
        if override or not self.n_in:
            self.n_in = input_type.channels
        self._build()

    def get_output_type(self, input_type):
        h, w = (conv_out_size(size, k, s, p, d, self.convolution_mode)
                for size, k, s, p, d in zip(
                    (input_type.height, input_type.width), self.kernel_size,
                    self.stride, self.padding, self.dilation))
        return InputType.convolutional(h, w, self.n_out)

    def jax_param_map(self):
        if getattr(self, "W", None) is None:
            return {}
        return {"W": self.W, "b": self.b} if self.has_bias else {"W": self.W}

    def init_weights(self, key):
        kh, kw = self.kernel_size
        init_weight_(self, self.W, key, fan_in=self.n_in * kh * kw,
                     fan_out=self.n_out * kh * kw)
        if self.has_bias:
            with torch.no_grad():
                self.b.fill_(self.bias_init)

    def pre_output(self, x):
        pads = _explicit_padding(self.convolution_mode, self.padding,
                                 self.kernel_size, self.dilation,
                                 self.stride, x.shape[1:3])
        if not _symmetric(pads):
            x, pads = _pad_nhwc(x, pads), [(0, 0), (0, 0)]
        W = quant.weight(self, "W")
        b = quant.weight(self, "b") if self.has_bias else None
        z = F.conv2d(_nchw(x), W.permute(3, 2, 0, 1), b, self.stride,
                     (pads[0][0], pads[1][0]), self.dilation)
        return _nhwc(z)

    def forward(self, x, *, train=False, rng=None, mask=None):
        x = self.apply_input_dropout(x, train, rng)
        return self.activation(self.pre_output(x))


@register_layer
class SubsamplingLayer(Layer):
    """Spatial pooling over NHWC input (MAX, AVG, SUM, PNORM) with JAX's
    windows, padding and AVG count; no params, no activation."""

    layer_name = "subsampling"
    FIELDS = (("pooling_type", PoolingMode.MAX), ("kernel_size", (2, 2)),
              ("stride", (2, 2)), ("padding", (0, 0)),
              ("convolution_mode", ConvolutionMode.TRUNCATE), ("pnorm", 2))
    DEFAULT_ACTIVATION = "identity"

    def __init__(self, **config):
        super().__init__(**config)
        self.kernel_size = _pair(self.kernel_size)
        self.stride = _pair(self.stride)
        self.padding = _pair(self.padding)
        self.pooling_type = PoolingMode(self.pooling_type)
        self.convolution_mode = ConvolutionMode(self.convolution_mode)

    def get_output_type(self, input_type):
        h, w = (conv_out_size(size, k, s, p, 1, self.convolution_mode)
                for size, k, s, p in zip(
                    (input_type.height, input_type.width), self.kernel_size,
                    self.stride, self.padding))
        return InputType.convolutional(h, w, input_type.channels)

    def _sum_pool(self, x, pads):
        """Window sums of NHWC `x` zero-padded by `pads`."""
        return _nhwc(F.avg_pool2d(_nchw(_pad_nhwc(x, pads)),
                                  self.kernel_size, self.stride,
                                  divisor_override=1))

    def forward(self, x, *, train=False, rng=None, mask=None):
        k, s = self.kernel_size, self.stride
        pads = _explicit_padding(self.convolution_mode, self.padding, k,
                                 (1, 1), s, x.shape[1:3])
        # PyTorch pads symmetrically, and at most half the window
        native = _symmetric(pads) and all(
            p <= kk // 2 for (p, _), kk in zip(pads, k))
        pt = self.pooling_type
        if pt == PoolingMode.MAX:
            if native:
                return _nhwc(F.max_pool2d(_nchw(x), k, s,
                                          (pads[0][0], pads[1][0])))
            return _nhwc(F.max_pool2d(
                _nchw(_pad_nhwc(x, pads, float("-inf"))), k, s))
        if pt == PoolingMode.AVG:
            if native:
                return _nhwc(F.avg_pool2d(_nchw(x), k, s,
                                          (pads[0][0], pads[1][0]),
                                          count_include_pad=False))
            ones = torch.ones((1, *x.shape[1:3], 1), dtype=x.dtype,
                              device=x.device)
            return self._sum_pool(x, pads) / self._sum_pool(ones, pads)
        if pt == PoolingMode.SUM:
            return self._sum_pool(x, pads)
        p = float(self.pnorm)
        return self._sum_pool(x.abs() ** p, pads) ** (1.0 / p)


@register_layer
class ZeroPaddingLayer(Layer):
    """Zero padding of NHWC activations: `pad` is an int, (h, w) or
    ((top, bottom), (left, right)), held as the last."""

    layer_name = "zeropadding"
    FIELDS = (("pad", 1),)
    DEFAULT_ACTIVATION = "identity"

    def __init__(self, **config):
        super().__init__(**config)
        p = self.pad
        if isinstance(p, int):
            self.pad = ((p, p), (p, p))
        elif len(p) == 2 and isinstance(p[0], int):
            self.pad = ((p[0], p[0]), (p[1], p[1]))
        else:
            self.pad = tuple((int(a), int(b)) for a, b in p)

    def get_output_type(self, input_type):
        (t, b), (l, r) = self.pad
        return InputType.convolutional(input_type.height + t + b,
                                       input_type.width + l + r,
                                       input_type.channels)

    def forward(self, x, *, train=False, rng=None, mask=None):
        return _pad_nhwc(x, self.pad)
