"""Viterbi max-product decode: CUDA kernel + plain version.

No Pallas kernel stands behind this one: the JAX package runs
`_viterbi_core` (`deeplearning4j_tpu/util/viterbi.py:27-53`) as one XLA
program, a `lax.scan` over the T steps and a reverse scan for the
backtrace. Written as PyTorch ops each step is a launch or five, so the
whole decode is one kernel (`csrc/viterbi.cu`; its note gives the bound,
operations, and the design: one block, a thread a state).

`viterbi(log_emissions [T, S], log_trans [S, S], log_prior [S])` returns
``(score, path)``: the best path's log-probability as a 0-d float32
tensor and the path as int32 [T], on the inputs' device, as
`_viterbi_core` returns them. Every step is adds and a max, so kernel,
plain version and JAX agree bit for bit; ties take the first index
(`torch.argmax`, never the indices of `torch.max(dim)`).

Dispatch as in every wrapper: CUDA tensors launch the kernel or raise,
CPU tensors take the plain version. `LAUNCHES["viterbi"]` counts the
kernel's launches (one a decode).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from deeplearning4j_tpu_torch import kernels as K
from deeplearning4j_tpu_torch.kernels import build


def _check(log_emissions, log_trans, log_prior):
    for name, t in (("log_emissions", log_emissions),
                    ("log_trans", log_trans), ("log_prior", log_prior)):
        if t.dtype != torch.float32:
            raise TypeError(f"viterbi takes float32 tables; {name} is "
                            f"{t.dtype}")
    if log_emissions.dim() != 2 or log_emissions.shape[0] < 1:
        raise ValueError(f"log_emissions must be [T >= 1, S]; got "
                         f"{tuple(log_emissions.shape)}")
    S = log_emissions.shape[1]
    if tuple(log_trans.shape) != (S, S) or tuple(log_prior.shape) != (S,):
        raise ValueError(f"log_trans must be [{S}, {S}] and log_prior "
                         f"[{S}]; got {tuple(log_trans.shape)}, "
                         f"{tuple(log_prior.shape)}")


# ------------------------------------------------------------ plain version
@torch.no_grad()
def viterbi_plain(log_emissions: torch.Tensor, log_trans: torch.Tensor,
                  log_prior: torch.Tensor):
    """Plain PyTorch version on the inputs' device: the forward recursion
    a step at a time over the transposed transitions (``scores[j, i] =
    prev[i] + log_trans[i, j]``, so each state's argmax runs along a
    contiguous row; the best value is read back at its argmax), the
    backtrace over the host copy of the backpointers."""
    _check(log_emissions, log_trans, log_prior)
    T, S = log_emissions.shape
    dev = log_emissions.device
    trans_t = log_trans.T.contiguous()
    prev = log_prior + log_emissions[0]
    back = torch.empty((max(T - 1, 0), S), dtype=torch.int64, device=dev)
    scores = torch.empty((S, S), dtype=torch.float32, device=dev)
    best = torch.empty((S, 1), dtype=torch.float32, device=dev)
    for t in range(1, T):
        torch.add(trans_t, prev, out=scores)
        idx = back[t - 1]
        torch.argmax(scores, dim=1, out=idx)
        torch.gather(scores, 1, idx[:, None], out=best)
        prev = best[:, 0] + log_emissions[t]
    end = torch.argmax(prev)
    score = prev[end]
    ptr = back.cpu().numpy()
    path = np.empty(T, np.int32)
    s = path[T - 1] = int(end)
    for t in range(T - 1, 0, -1):
        s = path[t - 1] = ptr[t - 1, s]
    return score, torch.from_numpy(path).to(dev)


# --------------------------------------------------------------- the kernel
def _lib():
    fn = build.load("viterbi").dl4j_viterbi
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, I, I, P, P, P, P]
        fn.restype = I
    return fn


def viterbi(log_emissions: torch.Tensor, log_trans: torch.Tensor,
            log_prior: torch.Tensor):
    """(score, path) of the best state sequence: the kernel for CUDA
    tensors (made contiguous), the plain version for CPU ones."""
    if not K.on_cuda(log_emissions, log_trans, log_prior):
        return viterbi_plain(log_emissions, log_trans, log_prior)
    _check(log_emissions, log_trans, log_prior)
    em, tr, pr = (t.contiguous() for t in (log_emissions, log_trans,
                                           log_prior))
    T, S = em.shape
    dev = em.device
    back = torch.empty((max(T - 1, 1), S), dtype=torch.int32, device=dev)
    path = torch.empty(T, dtype=torch.int32, device=dev)
    score = torch.empty((), dtype=torch.float32, device=dev)
    status = _lib()(K.ptr(em), K.ptr(tr), K.ptr(pr), T, S, K.ptr(back),
                    K.ptr(path), K.ptr(score), K.stream_of(em))
    K.check_status("viterbi", status)
    K.count_launch("viterbi", torch.float32)
    return score, path
