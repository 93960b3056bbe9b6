"""Hand-written Hopper kernels (CUDA C++, sm_90a) with their plain
PyTorch versions — the port's counterpart of the JAX package's Pallas
kernels (`deeplearning4j_tpu/kernels/`).

Dispatch rule: a wrapper launches its CUDA kernel for CUDA tensors (or
raises) and runs the plain version only for tensors on the CPU. There
is no environment switch and no fallback from the kernel to the plain
version on the card.

`LAUNCHES` counts kernel launches per wrapper (plain-version calls do
not count), so a run can show that its main path went through the
kernels; `LAUNCHES_BY_DTYPE` splits the same launches by the dtype of
the instance, keyed "<kernel>/<dtype>" (the inputs' dtype; fused Adam's
is the gradients', its params and moments being fp32). Both are counted
by `count_launch`, the one call a wrapper makes where it launches;
`reset_launches()` zeroes both.
"""

from __future__ import annotations

import ctypes

import torch

LAUNCHES = {"layer_norm": 0, "residual_layer_norm": 0,
            "flash_attention_fwd": 0, "flash_attention_carry": 0,
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
            "fused_adam": 0, "dropout": 0, "threefry_bits": 0,
            "threefry_rows": 0, "viterbi": 0}


LAUNCHES_BY_DTYPE = {}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCHES_BY_DTYPE.clear()


def count_launch(name: str, dtype: torch.dtype, n: int = 1):
    """Count `n` launches of kernel `name`'s `dtype` instance."""
    LAUNCHES[name] += n
    key = f"{name}/{str(dtype).removeprefix('torch.')}"
    LAUNCHES_BY_DTYPE[key] = LAUNCHES_BY_DTYPE.get(key, 0) + n


def acc32(t: torch.Tensor) -> torch.Tensor:
    """`t` in the plain versions' accumulation dtype: float32 for the
    kernels' dtypes (float32, bfloat16), a float64 tensor as it is (the
    gradient checker runs the plain versions in float64 on the CPU)."""
    return t if t.dtype == torch.float64 else t.float()


# dtype codes shared with csrc/*.cu
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t: torch.Tensor) -> int:
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"kernel supports float32 and bfloat16; got {t.dtype}")
    return code


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check_status(name: str, status: int):
    """Raise on the cudaError_t the C entry point returned (its
    cudaGetLastError() after the launch): a refused launch never runs
    and a later synchronize would not report it."""
    if status != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {status}")


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on a CUDA device, False when all are
    on the CPU; mixed or other devices raise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors must all be on CUDA or all on the CPU; "
                     f"got {sorted(kinds)}")
