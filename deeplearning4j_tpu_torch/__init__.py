"""PyTorch/CUDA port of deeplearning4j_tpu (Hopper, sm_90a).

Mirrors the JAX package's layout (`kernels/`, `nn/layers/`, `nn/conf/`,
`nn/multilayer.py`, `zoo/transformer.py`, `serving/`,
`util/serializer.py`) so every counterpart is easy to find. The port imports `torch` and never `jax`
or anything from `deeplearning4j_tpu`.

Device rule: entry points take an explicit `device=` that defaults to
``"cuda"`` and raise when CUDA is absent. Each kernel wrapper launches
its hand-written CUDA kernel for a CUDA tensor and runs its plain
PyTorch version only for a tensor on the CPU — there is no switch and
no fallback between the two.
"""

from deeplearning4j_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
