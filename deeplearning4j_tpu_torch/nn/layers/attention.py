"""Multi-head attention (counterpart of
`deeplearning4j_tpu/nn/layers/attention.py`: `forward` :336,
`forward_with_cache` :199, `_attend_cached` :226,
`forward_with_paged_cache` :246, `_warn_sp_fallback` :106).

Params "Wq", "Wk", "Wv", "Wo" ([d, d], used as ``x @ W``) and biases
"bq".."bo" (the JAX layer's default `has_bias=True`; identity
activation, applied after Wo as in JAX). Heads split the model dim as
[B, T, H, Dh], the JAX layout. `attention_dropout` acts only while
training and is refused in `fit`; `n_out` other than `n_in` is not
ported.

`sequence_parallel="ring"|"ulysses"` makes the full-sequence forward
run ring or Ulysses attention over the mesh of an active
`parallel.sequence_sharding(mesh)` context (the config names only the
strategy; the mesh is runtime state). Without a context the local path
runs and a one-time warning says so, as in JAX.
"""

from __future__ import annotations

import logging

import torch

from deeplearning4j_tpu_torch.kernels.flash_attention import flash_attention
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import (
    Layer,
    init_weight_,
    new_param,
    register_layer,
)
from deeplearning4j_tpu_torch.parallel import (
    current_sequence_mesh,
    sequence_parallel_attention,
    ulysses_parallel_attention,
)

_NAMES = ("Wq", "Wk", "Wv", "Wo")
_SP_FALLBACK_WARNED = set()


def _warn_sp_fallback(layer_name, reason):
    """One-time notice when a layer configured for sequence parallelism
    takes the local-attention path, so silence cannot read as 'SP is
    on'."""
    key = (layer_name, reason)
    if key not in _SP_FALLBACK_WARNED:
        _SP_FALLBACK_WARNED.add(key)
        logging.getLogger(__name__).warning(
            "layer %s has sequence_parallel configured but fell back to "
            "local attention: %s — sequence-parallel memory/perf benefits "
            "do NOT apply to this forward", layer_name, reason)


@register_layer
class MultiHeadAttention(Layer):
    layer_name = "multi_head_attention"
    FIELDS = (("n_in", 0), ("n_out", 0), ("n_heads", 4), ("causal", False),
              ("has_bias", True), ("attention_dropout", None),
              ("use_flash", None), ("sequence_parallel", None))
    DEFAULT_ACTIVATION = "identity"

    def __init__(self, n_in: int = 0, n_heads: int = 4, **config):
        super().__init__(n_in=n_in, n_heads=n_heads, **config)
        # use_flash None or True: flash attention (the CUDA forward and
        # backward kernels on the card, their plain versions on the CPU;
        # under sequence parallelism the flash ring with the carry
        # kernel); False: the plain -inf masked softmax (or the plain
        # ring), differentiated by autograd
        if self.sequence_parallel not in (None, "ring", "ulysses"):
            raise ValueError(f"sequence_parallel must be None, 'ring' or "
                             f"'ulysses'; got {self.sequence_parallel!r}")
        self._build()

    def _build(self):
        d, self.n_heads = int(self.n_in), int(self.n_heads)
        self.n_in = d
        if not d or getattr(self, "Wq", None) is not None:
            return
        if self.n_out not in (0, d):
            raise NotImplementedError(
                f"MultiHeadAttention n_out={self.n_out} != n_in={d} is not "
                f"ported (ROADMAP Queue 1 item 5)")
        if d % self.n_heads:
            raise ValueError(f"model dim {d} must divide n_heads "
                             f"{self.n_heads}")
        for name in _NAMES:
            setattr(self, name, new_param((d, d), "cpu"))
            setattr(self, "b" + name[1:],
                    new_param((d,), "cpu") if self.has_bias else None)
        # 1/sqrt(Dh) rounded as the JAX layer computes it (in fp32)
        self.scale = float(1.0 / torch.sqrt(
            torch.tensor(float(self.head_dim), dtype=torch.float32)))

    def set_n_in(self, input_type, override=True):
        if override or not self.n_in:
            self.n_in = input_type.size
        if not self.n_out:
            self.n_out = self.n_in
        self._build()

    def get_output_type(self, input_type):
        return InputType.recurrent(self.n_out or self.n_in,
                                   getattr(input_type, "timesteps", None))

    @property
    def head_dim(self):
        return self.n_in // self.n_heads

    def jax_param_map(self):
        m = {}
        for name in _NAMES:
            m[name] = getattr(self, name)
            if self.has_bias:
                m["b" + name[1:]] = getattr(self, "b" + name[1:])
        return m

    def init_weights(self, gen: torch.Generator, owner: Layer = None):
        """Draw Wq, Wk, Wv, Wo by the `weight_init` of `owner` (a block
        that holds this attention; this layer by default). The biases
        stay zero, as the JAX layer makes them."""
        for name in _NAMES:
            init_weight_(owner or self, getattr(self, name), gen)

    def _project(self, x, name):
        z = torch.matmul(x, getattr(self, name))
        return z + getattr(self, "b" + name[1:]) if self.has_bias else z

    def heads(self, z):
        b, t, d = z.shape
        return z.reshape(b, t, self.n_heads, d // self.n_heads)

    def _qkv(self, x):
        return tuple(self.heads(self._project(x, n)) for n in ("Wq", "Wk", "Wv"))

    def _out(self, o):
        return self.activation(
            self._project(o.reshape(o.shape[0], o.shape[1], -1), "Wo"))

    # ------------------------------------------------------ full sequence
    def forward(self, x):
        q, k, v = self._qkv(x)
        if self.sequence_parallel:
            ctx = current_sequence_mesh()
            if ctx is None:
                _warn_sp_fallback(
                    self.name or type(self).__name__,
                    "no sequence_sharding(mesh) context active — wrap "
                    "fit/output in `with sequence_sharding(mesh):`")
            else:
                mesh, axis = ctx
                flash = self.use_flash is not False
                if self.sequence_parallel == "ring":
                    o = sequence_parallel_attention(
                        q, k, v, mesh, seq_axis=axis, causal=self.causal,
                        use_flash=flash)
                else:
                    o = ulysses_parallel_attention(
                        q, k, v, mesh, axis_name=axis, causal=self.causal,
                        use_flash=flash)
                return self._out(o)
        if self.use_flash is not False:
            return self._out(flash_attention(q, k, v, self.causal))
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * self.scale
        T = x.shape[1]
        if self.causal:
            keep = torch.ones((T, T), dtype=torch.bool,
                              device=x.device).tril()
            s = s.masked_fill(~keep, float("-inf"))
        w = torch.softmax(s, dim=-1)
        return self._out(torch.einsum("bhqk,bkhd->bqhd", w, v))

    # ------------------------------------------------------ cached decode
    def forward_with_cache(self, x, k_cache, v_cache, pos: int):
        """`x` [B, T, D] holds new tokens at global positions
        [pos, pos + T); the fixed-size caches [B, L, H, Dh] hold the
        first `pos`. The write start clamps to [0, L - T] as XLA's
        dynamic_update_slice does; the query positions do not clamp.
        Returns (y, k_cache, v_cache); the caches are written IN PLACE
        (the caller owns them; JAX returns updated copies)."""
        if not self.causal:
            raise ValueError("KV-cache decoding requires causal=True")
        q, k, v = self._qkv(x)
        B, T, L = x.shape[0], x.shape[1], k_cache.shape[1]
        start = max(0, min(int(pos), L - T))
        k_cache[:, start:start + T] = k.to(k_cache.dtype)
        v_cache[:, start:start + T] = v.to(v_cache.dtype)
        q_pos = (int(pos) + torch.arange(T, device=x.device)).expand(B, T)
        return self._attend_cached(q, k_cache, v_cache, q_pos), k_cache, v_cache

    def _attend_cached(self, q, k_seq, v_seq, q_pos):
        """Masked-softmax attention of `q` [B, T, H, Dh] over a cache view
        [B, L, H, Dh]; every slot past a row's `q_pos` [B, T] is masked
        with -inf. Shared by the monolithic and the paged decode paths."""
        L = k_seq.shape[1]
        s = torch.einsum("bqhd,bkhd->bhqk", q, k_seq.to(q.dtype)) * self.scale
        valid = (torch.arange(L, device=q.device)[None, None, :]
                 <= q_pos[:, :, None])                        # [B, T, L]
        s = s.masked_fill(~valid[:, None], float("-inf"))
        w = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v_seq.to(q.dtype))
        return self._out(o)

    def forward_with_paged_cache(self, x, k_pool, v_pool, block_table, pos):
        """One new token per serving slot over the paged pool: `x`
        [S, 1, D], `pos` [S] (int64) each slot's position, `block_table`
        [S, max_blocks] (int64) slot-local block -> pool block. The pools
        [n_blocks, block_len, H, Dh] are UPDATED IN PLACE (JAX returns new
        arrays; in place saves a pool copy per layer and step). The table
        index clamps at the budget edge like XLA's gather: a finished
        slot that keeps decoding inside a chunk writes into its own last
        block or the garbage block, never another slot's. Returns y."""
        if not self.causal:
            raise ValueError("paged KV-cache decoding requires causal=True")
        S, bl = x.shape[0], k_pool.shape[1]
        q, k, v = self._qkv(x)
        rows = torch.arange(S, device=x.device)
        bi = torch.clamp(pos // bl, max=block_table.shape[1] - 1)
        blk = block_table[rows, bi]
        off = pos % bl
        k_pool[blk, off] = k[:, 0].to(k_pool.dtype)
        v_pool[blk, off] = v[:, 0].to(v_pool.dtype)
        # gather-by-table view [S, maxB * bl, H, Dh]: position p of a
        # slot sits at gathered index p, as in the monolithic cache
        k_seq = k_pool[block_table].reshape(S, -1, *k_pool.shape[2:])
        v_seq = v_pool[block_table].reshape(S, -1, *v_pool.shape[2:])
        return self._attend_cached(q, k_seq, v_seq, pos[:, None])
