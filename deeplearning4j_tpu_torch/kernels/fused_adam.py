"""Fused Adam over a run of layers: CUDA kernel + plain version.

Counterpart of `deeplearning4j_tpu/kernels/fused_adam.py`
(`adam_update_packed` :206, kernel `_adam_kernel` :78). The CUDA source
is `csrc/fused_adam.cu`; its note gives the bound (device-memory bytes)
and the design (a multi-tensor apply over a pointer table: one launch
covers every leaf of a run, up to 96 leaves a launch).

Params stay `nn.Parameter`s in their layers' layout, so the JAX
`_layout` relayout into one [rows, 128] buffer has no counterpart; m/v
live per leaf. Both versions update p, m and v IN PLACE (JAX returns
new arrays). Numerics are `common.updaters.Adam.apply` followed by
``p - upd``: the plain version calls exactly that, and the kernel
repeats its expression tree with every operation rounded on its own,
so in fp32 the two agree bit for bit. Grads are upcast to the param
dtype (fp32) first, as the JAX containers do.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from deeplearning4j_tpu_torch import kernels as K
from deeplearning4j_tpu_torch.common.updaters import Adam, adam_scalars, f32
from deeplearning4j_tpu_torch.kernels import build

MAX_LEAVES = 96      # leaves per launch (the table fits the 4 KB of params)


# ------------------------------------------------------------ plain version
@torch.no_grad()
def adam_update_plain(updater: Adam, params: Sequence[torch.Tensor],
                      grads: Sequence[torch.Tensor],
                      ms: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
                      step: int):
    """Plain PyTorch version: per leaf `Adam.apply` on the upcast grad,
    then ``p -= upd`` and m, v replaced — all in place."""
    for p, g, m, v in zip(params, grads, ms, vs):
        upd, new = updater.apply(g.to(p.dtype), {"m": m, "v": v}, step)
        p.sub_(upd)
        m.copy_(new["m"])
        v.copy_(new["v"])


# --------------------------------------------------------------- the kernel
def _lib():
    fn = build.load("fused_adam").dl4j_fused_adam
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        PP = ctypes.POINTER(ctypes.c_void_p)
        fn.argtypes = [I, I, PP, PP, PP, PP,
                       ctypes.POINTER(ctypes.c_longlong),
                       F, F, F, F, F, F, F, F, I, P]
        fn.restype = ctypes.c_int
    return fn


def _check(params, grads, ms, vs):
    if not (len(params) == len(grads) == len(ms) == len(vs)):
        raise ValueError("params, grads, m and v lists differ in length")
    gdt = grads[0].dtype if grads else torch.float32
    for p, g, m, v in zip(params, grads, ms, vs):
        if p.dtype != torch.float32 or m.dtype != p.dtype or v.dtype != p.dtype:
            raise TypeError("fused Adam keeps fp32 params and moments; got "
                            f"{p.dtype}/{m.dtype}/{v.dtype}")
        if g.dtype != gdt:
            raise TypeError(f"grads of one launch share a dtype; got {gdt} "
                            f"and {g.dtype}")
        if not (g.shape == p.shape == m.shape == v.shape):
            raise ValueError(f"leaf shapes differ: p {tuple(p.shape)}, g "
                             f"{tuple(g.shape)}, m {tuple(m.shape)}, "
                             f"v {tuple(v.shape)}")
        if not _dense(p):
            raise ValueError("fused Adam needs dense leaves")
        for t in (p, g, m, v):
            if t.stride() != p.stride():
                raise ValueError("fused Adam needs g, m and v laid out as "
                                 "their param")
            if t.device != p.device:
                raise ValueError("leaves on different devices")


def _dense(t: torch.Tensor) -> bool:
    """True when `t` covers numel() consecutive elements from its
    data_ptr() (contiguous, or a permutation of contiguous dims, as a
    convolution's HWIO weight over OHWI memory is): the kernel walks
    each leaf as flat memory, and an elementwise update does not care
    in which order."""
    dims = sorted((st, sz) for st, sz in zip(t.stride(), t.shape) if sz != 1)
    expect = 1
    for st, sz in dims:
        if st != expect:
            return False
        expect *= sz
    return True


@torch.no_grad()
def adam_update_packed(updater: Adam, params: Sequence[torch.Tensor],
                       grads: Sequence[torch.Tensor],
                       ms: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
                       step: int):
    """One fused Adam update of every leaf given (the JAX
    `adam_update_packed`), in place. CUDA tensors launch the kernel, one
    launch per 96 leaves; CPU tensors take the plain version."""
    if type(updater) is not Adam:
        raise TypeError(f"fused Adam takes exactly the Adam rule; got "
                        f"{type(updater).__name__}")
    leaves = [*params, *grads, *ms, *vs]
    if not leaves:
        return
    if not K.on_cuda(*leaves):
        return adam_update_plain(updater, params, grads, ms, vs, step)
    _check(params, grads, ms, vs)
    keep = [i for i, p in enumerate(params) if p.numel() > 0]
    n = len(keep)
    if n == 0:
        return
    lr, bc1, bc2 = adam_scalars(updater, step)

    def table(ts):
        return (ctypes.c_void_p * n)(*(ts[i].data_ptr() for i in keep))

    sizes = (ctypes.c_longlong * n)(*(params[i].numel() for i in keep))
    dev = params[keep[0]].device
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    status = _lib()(K.dtype_code(grads[keep[0]]), n, table(params),
                    table(grads), table(ms), table(vs), sizes, lr, bc1, bc2,
                    f32(updater.beta1), f32(1 - updater.beta1),
                    f32(updater.beta2), f32(1 - updater.beta2),
                    f32(updater.epsilon), n_sm, K.stream_of(params[keep[0]]))
    K.check_status("fused_adam", status)
    K.count_launch("fused_adam", grads[keep[0]].dtype,
                   -(-n // MAX_LEAVES))
