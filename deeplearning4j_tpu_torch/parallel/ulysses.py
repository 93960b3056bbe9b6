"""All-to-all sequence parallelism, DeepSpeed-Ulysses style (counterpart
of `deeplearning4j_tpu/parallel/ulysses.py`: `ulysses_parallel_attention`
:86 over `ulysses_attention` :49).

T is split into P shards over the mesh axis. The first all-to-all gives
device g head group g (H / P heads) of every shard, gathered along T;
each device runs full-sequence attention for its heads (the flash
autograd function, or with `use_flash=False` the plain masked softmax
`reference_attention`, the JAX `_full_attention`); the second
all-to-all returns every device its own T shard of all heads. One process drives every device, so an all-to-all is a set of
`tensor.to(device)` copies (no-ops on a mesh that repeats one card).
There is no kernel of its own here.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.kernels.flash_attention import flash_attention
from deeplearning4j_tpu_torch.parallel.mesh import gather, on_device, shard
from deeplearning4j_tpu_torch.parallel.ring import reference_attention


def ulysses_parallel_attention(q, k, v, mesh, *, axis_name: str = "seq",
                               causal: bool = False,
                               use_flash: bool = False):
    """Full arrays [B, T, H, Dh]; shards T over `axis_name`, runs the
    all-to-all schedule, returns full [B, T, H, Dh] on q's device.
    Requires H and T to divide by the axis size; differentiable."""
    devices = mesh.axis_devices(axis_name)
    P = len(devices)
    T, H = q.shape[1], q.shape[2]
    if H % P:
        raise ValueError(f"num_heads={H} must divide by seq devices={P}")
    Hg = H // P

    def to_heads(x):
        # seq-sharded [B, T/P, H, Dh] -> head group g on device g,
        # [B, T, H/P, Dh], the shards concatenated along T in order
        shards = shard(x, devices)
        return [torch.cat([s[:, :, g * Hg:(g + 1) * Hg].to(dev)
                           for s in shards], dim=1)
                for g, dev in enumerate(devices)]

    outs = []
    for qh, kh, vh, dev in zip(to_heads(q), to_heads(k), to_heads(v),
                               devices):
        with on_device(dev):
            outs.append(flash_attention(qh, kh, vh, causal) if use_flash
                        else reference_attention(qh, kh, vh, causal))
    # head-sharded -> seq-sharded: device j takes its T shard of every
    # head group, concatenated along heads
    Tl = T // P
    seq = [torch.cat([o[:, j * Tl:(j + 1) * Tl].to(dev) for o in outs], dim=2)
           for j, dev in enumerate(devices)]
    return gather(seq, q.device)
