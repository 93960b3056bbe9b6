"""Positional encoding and the pre-LN transformer block (counterpart of
`deeplearning4j_tpu/nn/layers/transformer.py`: `PositionalEncodingLayer`
:33, `TransformerEncoderBlock` :103, `forward_paged_multi` :296,
`stream_budget` :348).

Block: h = x + MHA(LN1(x)); out = h + FFN(LN2(h)). The full-sequence
forward (`_forward_impl`, the scoring and training path) runs LN1
through the LayerNorm kernel, attention through the flash kernels and
the residual add + LN2 through the fused residual+LayerNorm kernel, each
an autograd function; in training the block's dropouts run the dropout
kernel. A padding mask or attention dropout moves the attention to its
plain masked softmax (flash is the plain path only). The streaming
paths (KV-cache carry and paged decode) share `_stream_tail`, which
uses the plain residual add and the LayerNorm kernel — the JAX package
keeps the fused residual form off the decode path too.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.common import prng
from deeplearning4j_tpu_torch.common.activations import get_activation
from deeplearning4j_tpu_torch.kernels.layernorm import residual_layer_norm
from deeplearning4j_tpu_torch.nd import quant
from deeplearning4j_tpu_torch.nn.layers.attention import MultiHeadAttention
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import (
    init_weight_,
    new_param,
    register_layer,
)
from deeplearning4j_tpu_torch.nn.layers.normalization import LayerNormalization
from deeplearning4j_tpu_torch.nn.layers.recurrent import BaseRecurrentLayer


def sinusoid_table(T: int, D: int) -> np.ndarray:
    pos = np.arange(T)[:, None]
    i = np.arange(D // 2)[None, :]
    angles = pos / np.power(10000.0, 2.0 * i / D)
    table = np.zeros((T, D), np.float32)
    table[:, 0::2] = np.sin(angles)
    table[:, 1::2] = np.cos(angles[:, : D - D // 2])
    return table


@register_layer
class PositionalEncodingLayer(BaseRecurrentLayer):
    """Adds the parameter-free sinusoidal signal to [B, T, D]. The carry
    is the stream's position offset (a host int)."""

    layer_name = "positional_encoding"
    FIELDS = (("n_out", 0), ("max_len", 2048))
    DEFAULT_ACTIVATION = "identity"

    def __init__(self, n_out: int = 0, max_len: int = 2048, **config):
        super().__init__(n_out=n_out, max_len=max_len, **config)
        self._build()

    def _build(self):
        self.n_out, self.max_len = int(self.n_out), int(self.max_len)
        t = getattr(self, "table", None)
        if self.n_out and (t is None or tuple(t.shape) != (self.max_len,
                                                            self.n_out)):
            self.register_buffer(
                "table", torch.from_numpy(sinusoid_table(self.max_len,
                                                         self.n_out)),
                persistent=False)

    def set_n_in(self, input_type, override=True):
        if override or not self.n_out:
            self.n_out = input_type.size
        self._build()

    def forward(self, x, *, train=False, rng=None, mask=None):
        T = x.shape[1]
        rows = (self.table[:T] if T <= self.max_len else
                torch.from_numpy(sinusoid_table(T, self.n_out)).to(x.device))
        return x + rows.to(x.dtype)

    def init_carry(self, batch, dtype, device):
        return 0

    def forward_with_carry(self, x, carry: int, mask=None, *, train=False,
                           rng=None):
        T = x.shape[1]
        # dynamic_slice semantics: the start clamps to [0, max_len - T]
        start = max(0, min(int(carry), self.max_len - T))
        return x + self.table[start:start + T].to(x.dtype), int(carry) + T

    def forward_at_positions(self, x, positions):
        """Per-slot signal for paged decode: `x` [S, T, D], `positions`
        [S] (one token a slot) or [S, T] (int64). Positions past max_len
        clamp, as XLA's gather does."""
        idx = positions.clamp(0, self.max_len - 1)
        rows = self.table[idx]
        if rows.ndim == 2:
            rows = rows[:, None, :]
        return x + rows.to(x.dtype)


@register_layer
class TransformerEncoderBlock(BaseRecurrentLayer):
    """`ff_activation` (gelu by default) is looked up at each call, as the
    JAX block does. `bias_init` leaves the block's biases at zero, as in
    JAX, whose block fills none of them with it. `dropout` drops the
    attention's and the FFN's outputs and `attention_dropout` the
    softmax weights, while training; `remat` (the legacy flag) means
    `remat_policy="full"` to the containers' training call (memory
    changes, numbers do not)."""

    layer_name = "transformer_encoder"
    FIELDS = (("n_in", 0), ("n_heads", 8), ("ff_multiplier", 4),
              ("causal", False), ("attention_dropout", None),
              ("ff_activation", "gelu"), ("use_flash", None),
              ("sequence_parallel", None), ("cache_len", 512),
              ("remat", False))
    DEFAULT_ACTIVATION = "identity"

    def __init__(self, n_in: int = 0, n_heads: int = 8,
                 ff_multiplier: int = 4, **config):
        super().__init__(n_in=n_in, n_heads=n_heads,
                         ff_multiplier=ff_multiplier, **config)
        if self.sequence_parallel not in (None, "ring", "ulysses"):
            raise ValueError(f"sequence_parallel must be None, 'ring' or "
                             f"'ulysses'; got {self.sequence_parallel!r}")
        self._build()

    def _build(self):
        d = self.n_in = int(self.n_in)
        self.n_heads, self.cache_len = int(self.n_heads), int(self.cache_len)
        self.ff_multiplier = int(self.ff_multiplier)
        if not d or getattr(self, "attn", None) is not None:
            return
        # "ring"|"ulysses": the attention's full-sequence forward runs
        # sequence-parallel under `parallel.sequence_sharding(mesh)`
        self.attn = MultiHeadAttention(
            d, self.n_heads, causal=self.causal, use_flash=self.use_flash,
            sequence_parallel=self.sequence_parallel)
        self.ln1 = LayerNormalization(d)
        self.ln2 = LayerNormalization(d)
        ff = d * self.ff_multiplier
        self.ff_W1 = new_param((d, ff), "cpu")
        self.ff_b1 = new_param((ff,), "cpu")
        self.ff_W2 = new_param((ff, d), "cpu")
        self.ff_b2 = new_param((d,), "cpu")

    def set_n_in(self, input_type, override=True):
        if override or not self.n_in:
            self.n_in = input_type.size
        self._build()

    def get_output_type(self, input_type):
        return InputType.recurrent(self.n_in,
                                   getattr(input_type, "timesteps", None))

    def jax_param_map(self):
        m = {f"attn_{k}": v for k, v in self.attn.jax_param_map().items()}
        m.update({f"ln1_{k}": v for k, v in self.ln1.jax_param_map().items()})
        m.update({f"ln2_{k}": v for k, v in self.ln2.jax_param_map().items()})
        m.update(ff_W1=self.ff_W1, ff_b1=self.ff_b1, ff_W2=self.ff_W2,
                 ff_b2=self.ff_b2)
        return m

    def quantizable_weights(self):
        return ("attn_Wq", "attn_Wk", "attn_Wv", "attn_Wo", "ff_W1",
                "ff_W2")

    def init_weights(self, key):
        """The JAX block's `init_params`: the attention under
        `fold_in(key, 0)`, ff_W1 and ff_W2 under folds 11 and 12; the
        LayerNorms and biases at their constants."""
        self.attn.init_weights(prng.fold_in(key, 0), owner=self)
        init_weight_(self, self.ff_W1, prng.fold_in(key, 11))
        init_weight_(self, self.ff_W2, prng.fold_in(key, 12))

    def _ffn(self, h):
        act = get_activation(self.ff_activation)
        W = quant.weight
        h = act(quant.matmul(h, W(self, "ff_W1")) + W(self, "ff_b1"))
        return quant.matmul(h, W(self, "ff_W2")) + W(self, "ff_b2")

    # ------------------------------------------------------ full sequence
    def forward(self, x, *, train=False, rng=None, mask=None):
        return self._forward_impl(x, train, rng, mask)

    def _forward_impl(self, x, train=False, rng=None, mask=None):
        """The JAX `_forward_impl` (:201-232): the block's key folds to 1
        for the attention (its attention dropout), 2 for the dropout of
        the attention's output and 3 for the FFN's; both dropouts are
        the block's `dropout`, and the fused residual+LayerNorm takes
        the dropped attention output."""
        def fold(i):
            return None if rng is None else prng.fold_in(rng, i)

        h = self.ln1(x)
        h = self.attn.attend(h, train, fold(1), mask, self.attention_dropout)
        h = self.apply_input_dropout(h, train, fold(2))
        x, h = residual_layer_norm(x.contiguous(), h.contiguous(),
                                   quant.weight(self.ln2, "gamma"),
                                   quant.weight(self.ln2, "beta"),
                                   self.ln2.eps)
        return x + self.apply_input_dropout(self._ffn(h), train, fold(3))

    # ---------------------------------------------------------- streaming
    def init_carry(self, batch, dtype, device):
        shape = (batch, self.cache_len, self.n_heads,
                 self.n_in // self.n_heads)
        return (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device), 0)

    def forward_with_carry(self, x, carry, mask=None, *, train=False,
                           rng=None):
        """KV-cache streaming step; carry = (k_cache, v_cache, pos). A
        padding mask is refused, as JAX's block refuses it (:267-275): a
        masked token's K/V would enter the cache. In training (truncated
        BPTT) the residual and FFN dropouts apply under the block key's
        folds 2 and 3, as on JAX's carry path (:317-335); the attention
        dropout does not."""
        if mask is not None:
            raise ValueError(
                "TransformerEncoderBlock cannot stream (forward_with_carry) "
                "with a padding mask: masked tokens' K/V would enter the "
                "cache; strip padding before streaming")
        return self._carry_impl(x, carry, train, rng)

    def _carry_impl(self, x, carry, train=False, rng=None):
        k_cache, v_cache, pos = carry
        h = self.ln1(x)
        h, k_cache, v_cache = self.attn.forward_with_cache(
            h, k_cache, v_cache, pos)
        return (self._stream_tail(x, h, train, rng),
                (k_cache, v_cache, int(pos) + x.shape[1]))

    def forward_paged(self, x, k_pool, v_pool, block_table, pos):
        """Paged decode step: attention reads/writes the shared pool (in
        place) through the slot batch's block table; the rest of the block
        is `_stream_tail`, the carry path's own body. Returns y."""
        h = self.ln1(x)
        h = self.attn.forward_with_paged_cache(h, k_pool, v_pool,
                                               block_table, pos)
        return self._stream_tail(x, h)

    def forward_paged_multi(self, x, k_pool, v_pool, block_table, pos,
                            n_valid):
        """K-position paged step (the speculative score, the suffix
        extension): `x` [S, K, D] at positions `pos[s] ..`, `n_valid`
        [S] real lanes a slot (`MultiHeadAttention.
        forward_with_paged_cache_multi`); the rest is `_stream_tail`.
        Returns y."""
        h = self.ln1(x)
        h = self.attn.forward_with_paged_cache_multi(
            h, k_pool, v_pool, block_table, pos, n_valid)
        return self._stream_tail(x, h)

    def _stream_tail(self, x, h, train=False, rng=None):
        """Post-attention half shared by both streaming paths: dropout,
        residual, LN2, FFN, dropout, residual."""
        def fold(i):
            return None if rng is None else prng.fold_in(rng, i)

        x = x + self.apply_input_dropout(h, train, fold(2))
        return x + self.apply_input_dropout(self._ffn(self.ln2(x)), train,
                                            fold(3))


def stream_budget(layers):
    """Smallest bounded stream length (KV cache_len / positional max_len)
    in a layer stack, or None."""
    limits = [l.cache_len for l in layers
              if isinstance(l, TransformerEncoderBlock)]
    limits += [l.max_len for l in layers
               if isinstance(l, PositionalEncodingLayer)]
    return min(limits) if limits else None
