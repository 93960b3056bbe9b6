"""MultiLayerNetwork — the sequential container, inference side
(counterpart of `deeplearning4j_tpu/nn/multilayer.py`: `_forward_core`
:210, `output` :878). Training (`fit`, losses, updaters) is a later
slice.

Layers live in an `nn.ModuleList` in the JAX net's order, so layer `i`
here is layer `i` there and `util.jax_params.from_jax_params` can load
the JAX net's `{"<i>": {name: array}}` params directly. PyTorch runs
eagerly: there is no jit, no scan-over-layers and no pytree — the
forward is a Python loop over the layers.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn.layers.recurrent import BaseRecurrentLayer


class MultiLayerNetwork(nn.Module):
    def __init__(self, layers: List[nn.Module], *, device="cuda"):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.dtype = torch.float32     # the fp32 policy (mixed_bf16: later)
        self.device = resolve_device(device)
        super().to(self.device)

    def to(self, device):
        """Move every parameter and buffer to `device` (resolved like an
        entry point's `device=`)."""
        self.device = resolve_device(device)
        return super().to(self.device)

    def init_carries(self, batch: int) -> Dict[str, object]:
        return {str(i): layer.init_carry(batch, self.dtype, self.device)
                for i, layer in enumerate(self.layers)
                if isinstance(layer, BaseRecurrentLayer)}

    @torch.no_grad()
    def _forward_core(self, x, carries: Optional[Dict[str, object]] = None):
        """Shared forward. Without carries: each layer's full-sequence
        `forward`. With carries (streaming decode / prefill): recurrent
        layers run `forward_with_carry` from `carries[str(i)]` (their
        fresh carry when absent). Returns (h, new_carries)."""
        h = x
        new_carries = {}
        for i, layer in enumerate(self.layers):
            if carries is not None and isinstance(layer, BaseRecurrentLayer):
                carry = carries.get(str(i))
                if carry is None:
                    carry = layer.init_carry(h.shape[0], self.dtype,
                                             self.device)
                h, new_carries[str(i)] = layer.forward_with_carry(h, carry)
            else:
                h = layer(h)
        return h, new_carries

    def output(self, x):
        """Forward pass to the final activation (the JAX `output`, no
        mask): token ids [B, T] -> [B, T, V] softmax for the LM."""
        x = torch.as_tensor(x, device=self.device)
        h, _ = self._forward_core(x)
        return h.float()
