"""Ring attention: sequence parallelism over a mesh axis (counterpart of
`deeplearning4j_tpu/parallel/ring.py`: `ring_attention` :30,
`_ring_flash_fwd_impl` :108, `_ring_attention_flash` :161,
`sequence_parallel_attention` :248, `reference_attention` :266).

T is split into P equal shards and shard j lives on ring device j.
Each device keeps its queries and folds every K/V chunk into an
online-softmax state while the chunks rotate around the ring (device i
receives from device i + 1). JAX runs one program per device under
`shard_map` and rotates with `ppermute`; here one process drives every
ring position in turn, and a rotation is `tensor.to(device)`. On a mesh
whose devices repeat one card (`make_mesh(..., devices=["cuda:0"] * P)`)
that is a no-op and the P shards run one after the other; on distinct
cards it is a peer copy (not exercised on a one-card machine).

Two paths, as in JAX:
- `use_flash=False`: the XLA ring, in plain torch ops differentiated by
  autograd (-inf masks with the isfinite guards, state in q's dtype,
  o / clip(l, 1e-20)).
- `use_flash=True`: `_RingFlashFn`, the custom_vjp. The forward folds
  each chunk through `flash_attention_carry` (the carry-mode CUDA
  kernel): under `causal`, the diagonal chunk with `diag=True`, past
  chunks with `diag=False`, future chunks skipped, in the rotation's
  order so rounding follows JAX. The backward is a second ring through
  the dQ and dK/dV kernels (`causal = diag`); each chunk's fp32 dK/dV
  accumulator travels with the chunk and lands home after P rotations.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.kernels.flash_attention import (
    NEG_INF,
    attention_delta,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_carry,
)
from deeplearning4j_tpu_torch.parallel.mesh import gather, on_device, shard

MASKED, DIAG, VISIBLE = 0, 1, 2


def _ring_case(idx: int, src: int) -> int:
    """MASKED: src > idx (a future chunk), DIAG: the device's own chunk,
    VISIBLE: src < idx (a past chunk) — the JAX `_ring_case`."""
    return VISIBLE if src < idx else DIAG if src == idx else MASKED


def _rotate(blocks, devices):
    """One ring step: device j receives the block held by device j + 1
    (the JAX `_ring_perm` ppermute)."""
    P = len(devices)
    return [blocks[(j + 1) % P].to(devices[j], non_blocking=True)
            for j in range(P)]


def _scale(Dh, dtype):
    """1 / sqrt(Dh) computed in `dtype`, as the JAX paths compute it."""
    return float(1.0 / torch.sqrt(torch.tensor(float(Dh), dtype=dtype)))


# ---------------------------------------------------------- plain (XLA) ring
def _ring_plain(q, k, v, devices, causal):
    qs, ks, vs = (shard(t, devices) for t in (q, k, v))
    P = len(devices)
    B, Tl, H, Dh = qs[0].shape
    scale = _scale(Dh, q.dtype)

    def attend(idx, acc, k_blk, v_blk, step):
        m, l, o = acc
        qb = qs[idx]
        src = (idx + step) % P
        s = torch.einsum("bqhd,bkhd->bhqk", qb, k_blk) * scale
        if causal:
            q_pos = idx * Tl + torch.arange(Tl, device=qb.device)
            k_pos = src * Tl + torch.arange(Tl, device=qb.device)
            s = s.masked_fill(~(k_pos[None, :] <= q_pos[:, None]),
                              float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new,
                             torch.zeros_like(m_new))
        fin = torch.isfinite(s)
        p = torch.exp(torch.where(fin, s - m_safe[..., None],
                                  torch.full_like(s, float("-inf"))))
        p = torch.where(fin, p, torch.zeros_like(p))
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                           torch.zeros_like(m))
        l_new = l * corr + p.sum(dim=-1)
        o_new = o * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                   v_blk)
        return m_new, l_new, o_new

    accs = [(torch.full((B, H, Tl), float("-inf"), dtype=q.dtype, device=d),
             torch.zeros((B, H, Tl), dtype=q.dtype, device=d),
             torch.zeros((B, H, Tl, Dh), dtype=q.dtype, device=d))
            for d in devices]
    kb, vb = ks, vs
    for s in range(P):
        accs = [attend(j, accs[j], kb[j], vb[j], s) for j in range(P)]
        if s < P - 1:
            kb, vb = _rotate(kb, devices), _rotate(vb, devices)
    outs = [(o / torch.clamp(l[..., None], min=1e-20)).transpose(1, 2)
            for _, l, o in accs]
    return gather(outs, q.device)


# ------------------------------------------------------------ the flash ring
def _cases(P, causal, s):
    return [_ring_case(j, (j + s) % P) if causal else VISIBLE
            for j in range(P)]


class _RingFlashFn(torch.autograd.Function):
    """Differentiable flash ring attention over `devices` (the JAX
    `_ring_attention_flash` custom_vjp) on full [B, T, H, D] tensors."""

    @staticmethod
    def forward(ctx, q, k, v, devices, causal):
        P = len(devices)
        qs, ks, vs = (shard(t, devices) for t in (q, k, v))
        B, Tl, H, D = qs[0].shape
        state = [(torch.full((B, H, Tl), NEG_INF, dtype=torch.float32,
                             device=d),
                  torch.zeros((B, H, Tl), dtype=torch.float32, device=d),
                  torch.zeros((B, H, Tl, D), dtype=torch.float32, device=d))
                 for d in devices]
        kb, vb = ks, vs
        for s in range(P):
            for j, case in enumerate(_cases(P, causal, s)):
                if case == MASKED:
                    continue
                with on_device(devices[j]):
                    flash_attention_carry(qs[j], kb[j], vb[j], *state[j],
                                          diag=case == DIAG)
            if s < P - 1:
                kb, vb = _rotate(kb, devices), _rotate(vb, devices)
        outs, lses = [], []
        for m, l, acc in state:
            l_safe = torch.clamp(l, min=1e-20)
            outs.append((acc / l_safe[..., None]).transpose(1, 2).to(q.dtype))
            lses.append(m + torch.log(l_safe))
        o = gather(outs, q.device)
        ctx.save_for_backward(q, k, v, o, gather(lses, q.device, dim=2))
        ctx.devices, ctx.causal = devices, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        devices, causal = ctx.devices, ctx.causal
        P = len(devices)
        qs, ks, vs, os_, dos = (shard(t, devices) for t in (q, k, v, o, do))
        lses = [t.contiguous() for t in shard(lse, devices, dim=2)]
        deltas = [attention_delta(g, o_).contiguous()
                  for g, o_ in zip(dos, os_)]
        dq_a = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                for t in qs]
        # dk_a[j]: the accumulator device j holds now, which belongs to
        # the chunk it holds, (j + s) % P; it rotates with the chunk
        dk_a = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                for t in ks]
        dv_a = [torch.zeros_like(t) for t in dk_a]
        kb, vb = ks, vs
        for s in range(P):
            for j, case in enumerate(_cases(P, causal, s)):
                if case == MASKED:
                    continue
                args = (qs[j], kb[j], vb[j], dos[j], lses[j], deltas[j],
                        case == DIAG)
                with on_device(devices[j]):
                    dq_a[j] += flash_attention_bwd_dq(*args).float()
                    dk_c, dv_c = flash_attention_bwd_dkv(*args)
                    dk_a[j] += dk_c.float()
                    dv_a[j] += dv_c.float()
            if s < P - 1:
                kb, vb = _rotate(kb, devices), _rotate(vb, devices)
            dk_a, dv_a = _rotate(dk_a, devices), _rotate(dv_a, devices)
        return (gather(dq_a, q.device).to(q.dtype),
                gather(dk_a, k.device).to(k.dtype),
                gather(dv_a, v.device).to(v.dtype), None, None)


# ------------------------------------------------------------ entry points
def ring_attention(q, k, v, devices, causal: bool = False,
                   use_flash: bool = False):
    """Ring attention of full q, k, v [B, T, H, Dh] with T split over the
    ring `devices` (the JAX per-shard `ring_attention` with its
    shard_map folded in: one process drives every ring position).
    Returns o [B, T, H, Dh] on q's device; differentiable."""
    devices = tuple(torch.device(d) for d in devices)
    if use_flash:
        return _RingFlashFn.apply(q, k, v, devices, bool(causal))
    return _ring_plain(q, k, v, devices, bool(causal))


def sequence_parallel_attention(q, k, v, mesh, *, seq_axis: str = "seq",
                                causal: bool = False,
                                use_flash: bool = False):
    """Full arrays [B, T, H, Dh] -> ring attention with T sharded over
    `seq_axis` of `mesh` (T must divide by the axis size)."""
    return ring_attention(q, k, v, mesh.axis_devices(seq_axis),
                          causal=causal, use_flash=use_flash)


def reference_attention(q, k, v, causal: bool = False):
    """Exact attention on full sequences (the single-device ground truth
    for parity tests, and Ulysses' plain per-head-group attention)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * _scale(q.shape[-1], q.dtype)
    if causal:
        T = q.shape[1]
        keep = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
