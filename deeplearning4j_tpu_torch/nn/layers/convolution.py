"""Convolution, subsampling and zero padding (counterpart of
`deeplearning4j_tpu/nn/layers/convolution.py`: `ConvolutionMode` :39,
`_pair` :47, `conv_out_size` :53, `_explicit_padding` :66,
`ConvolutionLayer` :81-147, `SubsamplingLayer` :209-266,
`ZeroPaddingLayer` :322-353, `Convolution1DLayer` :149-197,
`Subsampling1DLayer` :268-295, `Upsampling2D` :298-320,
`ZeroPadding1DLayer` :355-376, `SpaceToDepthLayer` :378-395,
`Upsampling1D` :398-425, `SeparableConvolution2D` :429-512).

The 1D layers take recurrent [B, T, F] input through the 2D layers as
NHWC [B, T, 1, F], a kernel (k, 1) and padding (p, 0), as JAX does: an
int kernel, stride, padding or dilation becomes that pair, a tuple is
kept (so `Subsampling1DLayer`'s default stride and kernel stay (2, 2),
as in JAX). `SpaceToDepthLayer` follows JAX's reshape and transpose
order, which is not darknet's `reorg` order.

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
from deeplearning4j_tpu_torch.common import prng
from deeplearning4j_tpu_torch.nn.conf.inputs import (
    InputType,
    InputTypeConvolutional,
    InputTypeRecurrent,
)
from deeplearning4j_tpu_torch.nn.layers.base import (
    Layer,
    init_weight_,
    new_param,
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


def _time_pairs(config, names, second):
    """The 1D layers' config: an int among `names` becomes (v, second)
    (the JAX `__post_init__`), a list or tuple is kept."""
    for name, other in zip(names, second):
        v = config.get(name)
        if v is not None and not isinstance(v, (list, tuple)):
            config[name] = (v, other)
    return config


@register_layer
class Convolution1DLayer(ConvolutionLayer):
    """1D convolution over the time axis of [B, T, F] (RNN format in and
    out): the 2D layer over [B, T, 1, F] with W [k, 1, F, n_out]."""

    layer_name = "convolution1d"

    def __init__(self, **config):
        super().__init__(**_time_pairs(
            config, ("kernel_size", "stride", "padding", "dilation"),
            (1, 1, 0, 1)))

    def set_n_in(self, input_type, override=True):
        if not isinstance(input_type, InputTypeRecurrent):
            raise ValueError(f"Convolution1DLayer expects recurrent input, "
                             f"got {input_type}")
        if override or not self.n_in:
            self.n_in = input_type.size
        self._build()

    def get_output_type(self, input_type):
        t = input_type.timesteps
        if t is not None:
            t = conv_out_size(t, self.kernel_size[0], self.stride[0],
                              self.padding[0], self.dilation[0],
                              self.convolution_mode)
        return InputType.recurrent(self.n_out, t)

    def forward(self, x, *, train=False, rng=None, mask=None):
        x = self.apply_input_dropout(x, train, rng)
        return self.activation(self.pre_output(x[:, :, None, :])[:, :, 0, :])

    def forward_mask(self, mask):
        """The mask pooled with the convolution's window and padding, -inf
        padded: a step is valid where any step of its window is (JAX
        :186-197; the window is k steps, its padding counts dilation)."""
        k, s = self.kernel_size[0], self.stride[0]
        if mask is None or k == 1 and s == 1:
            return mask
        (lo, hi), = _explicit_padding(self.convolution_mode,
                                      (self.padding[0],), (k,),
                                      (self.dilation[0],), (s,),
                                      (mask.shape[1],))
        m = F.pad(mask[:, None, :].float(), (lo, hi), value=float("-inf"))
        return (F.max_pool1d(m, k, s)[:, 0] > 0).to(mask.dtype)


@register_layer
class Subsampling1DLayer(SubsamplingLayer):
    """Pooling over time for [B, T, F]: the 2D layer over [B, T, 1, F].
    It has no `forward_mask` of its own, as in JAX: the mask passes
    unchanged."""

    layer_name = "subsampling1d"

    def __init__(self, **config):
        super().__init__(**_time_pairs(
            config, ("kernel_size", "stride", "padding"), (1, 1, 0)))

    def get_output_type(self, input_type):
        t = input_type.timesteps
        if t is not None:
            t = conv_out_size(t, self.kernel_size[0], self.stride[0],
                              self.padding[0], 1, self.convolution_mode)
        return InputType.recurrent(input_type.size, t)

    def forward(self, x, *, train=False, rng=None, mask=None):
        return super().forward(x[:, :, None, :], train=train,
                               rng=rng)[:, :, 0, :]


@register_layer
class Upsampling2D(Layer):
    """Nearest-neighbour upsampling of NHWC by `size` (h, w)."""

    layer_name = "upsampling2d"
    FIELDS = (("size", 2),)
    DEFAULT_ACTIVATION = "identity"

    def __init__(self, **config):
        super().__init__(**config)
        self.size = _pair(self.size)

    def get_output_type(self, input_type):
        return InputType.convolutional(input_type.height * self.size[0],
                                       input_type.width * self.size[1],
                                       input_type.channels)

    def forward(self, x, *, train=False, rng=None, mask=None):
        return x.repeat_interleave(self.size[0], dim=1).repeat_interleave(
            self.size[1], dim=2)


@register_layer
class ZeroPadding1DLayer(Layer):
    """Zero padding of [B, T, F] along time: `pad` is an int or
    (before, after)."""

    layer_name = "zeropadding1d"
    FIELDS = (("pad", 1),)
    DEFAULT_ACTIVATION = "identity"

    def __init__(self, **config):
        super().__init__(**config)
        if isinstance(self.pad, int):
            self.pad = (self.pad, self.pad)

    def get_output_type(self, input_type):
        t = input_type.timesteps
        if t is not None:
            t = t + self.pad[0] + self.pad[1]
        return InputType.recurrent(input_type.size, t)

    def forward(self, x, *, train=False, rng=None, mask=None):
        return F.pad(x, (0, 0, int(self.pad[0]), int(self.pad[1])))


@register_layer
class SpaceToDepthLayer(Layer):
    """[B, H, W, C] -> [B, H/b, W/b, b*b*C] in JAX's order: (row in the
    block, column in the block, channel). Not darknet's `reorg`, so
    darknet weights do not load into a net built on it unchanged."""

    layer_name = "space_to_depth"
    FIELDS = (("block_size", 2),)

    def get_output_type(self, input_type):
        b = self.block_size
        return InputType.convolutional(input_type.height // b,
                                       input_type.width // b,
                                       input_type.channels * b * b)

    def forward(self, x, *, train=False, rng=None, mask=None):
        n, h, w, c = x.shape
        b = self.block_size
        out = x.reshape(n, h // b, b, w // b, b, c).permute(0, 1, 3, 2, 4, 5)
        return out.reshape(n, h // b, w // b, b * b * c)


@register_layer
class Upsampling1D(Layer):
    """Nearest-neighbour upsampling of [B, T, F] along time; the mask
    repeats with it."""

    layer_name = "upsampling1d"
    FIELDS = (("size", 2),)
    DEFAULT_ACTIVATION = "identity"

    def __init__(self, **config):
        super().__init__(**config)
        if isinstance(self.size, (tuple, list)):
            self.size = int(self.size[0])

    def get_output_type(self, input_type):
        if isinstance(input_type, InputTypeRecurrent):
            ts = (None if input_type.timesteps is None
                  else input_type.timesteps * self.size)
            return InputType.recurrent(input_type.size, ts)
        return input_type

    def forward(self, x, *, train=False, rng=None, mask=None):
        return x.repeat_interleave(self.size, dim=1)

    def forward_mask(self, mask):
        return None if mask is None else mask.repeat_interleave(self.size,
                                                                dim=1)


@register_layer
class SeparableConvolution2D(Layer):
    """Depthwise-separable convolution: a depthwise convolution
    (`groups=n_in`) by dW [kh, kw, n_in, dm], whose output channel
    i*dm + m (in-major, JAX's reshape to [kh, kw, 1, n_in*dm]) is input
    channel i's m-th filter, then a 1x1 pointwise convolution by pW
    [1, 1, n_in*dm, n_out] and the optional bias b [n_out]. The params
    keep JAX's shapes (HWIO)."""

    layer_name = "separable_convolution2d"
    FIELDS = (("n_in", 0), ("n_out", 0), ("kernel_size", (3, 3)),
              ("stride", (1, 1)), ("padding", (0, 0)), ("dilation", (1, 1)),
              ("depth_multiplier", 1),
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
        kh, kw = self.kernel_size
        dm = self.depth_multiplier = int(self.depth_multiplier)
        shape = (kh, kw, self.n_in, dm)
        dW = getattr(self, "dW", None)
        if not (self.n_in and self.n_out) or (
                dW is not None and tuple(dW.shape) == shape):
            return
        self.dW = new_param(shape, "cpu")
        self.pW = new_param((1, 1, self.n_in * dm, self.n_out), "cpu")
        self.b = new_param((self.n_out,), "cpu") if self.has_bias else None

    def set_n_in(self, input_type, override=True):
        if not isinstance(input_type, InputTypeConvolutional):
            raise ValueError(f"SeparableConvolution2D expects convolutional "
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
        if getattr(self, "dW", None) is None:
            return {}
        m = {"dW": self.dW, "pW": self.pW}
        if self.has_bias:
            m["b"] = self.b
        return m

    def init_weights(self, key):
        kh, kw = self.kernel_size
        dm = self.depth_multiplier
        k1, k2 = prng.split(key, 2)
        init_weight_(self, self.dW, k1, fan_in=kh * kw, fan_out=kh * kw * dm)
        init_weight_(self, self.pW, k2, fan_in=self.n_in * dm,
                     fan_out=self.n_out)
        if self.has_bias:
            with torch.no_grad():
                self.b.fill_(self.bias_init)

    def forward(self, x, *, train=False, rng=None, mask=None):
        x = self.apply_input_dropout(x, train, rng)
        kh, kw = self.kernel_size
        pads = _explicit_padding(self.convolution_mode, self.padding,
                                 self.kernel_size, self.dilation,
                                 self.stride, x.shape[1:3])
        if not _symmetric(pads):
            x, pads = _pad_nhwc(x, pads), [(0, 0), (0, 0)]
        # [kh, kw, in, dm] -> [in*dm, 1, kh, kw]: torch's groups take
        # output channels group by group, the in-major order
        dw = self.dW.reshape(kh, kw, -1).permute(2, 0, 1)[:, None]
        z = F.conv2d(_nchw(x), dw, None, self.stride,
                     (pads[0][0], pads[1][0]), self.dilation,
                     groups=self.n_in)
        z = _nhwc(F.conv2d(z, self.pW.permute(3, 2, 0, 1)))
        if self.has_bias:
            z = z + self.b
        return self.activation(z)
