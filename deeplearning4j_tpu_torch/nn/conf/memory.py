"""Memory estimates before training (counterpart of
`deeplearning4j_tpu/nn/conf/memory.py`: `LayerMemoryReport`,
`NetworkMemoryReport`, `memory_report`).

Per layer and for the whole network, from the configuration alone: the
parameter bytes, the updater's state (param-sized slots of the layer's
rule), and the activation bytes an example takes at the layer's output type.
Parameter shapes come from the port's layer objects, which build their
params when their widths are known; nothing is drawn or moved. Working
memory (the autograd graph, the kernels' scratch) is not modelled; the
report covers the tensors the framework keeps.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType


@dataclasses.dataclass
class LayerMemoryReport:
    layer_name: str
    layer_type: str
    parameter_bytes: int
    updater_state_bytes: int
    activation_bytes_per_example: int

    def total_fixed(self) -> int:
        # params + grads (same size) + updater state
        return 2 * self.parameter_bytes + self.updater_state_bytes


@dataclasses.dataclass
class NetworkMemoryReport:
    layer_reports: List[LayerMemoryReport]
    input_type: Optional[InputType]

    def total_parameter_bytes(self) -> int:
        return sum(r.parameter_bytes for r in self.layer_reports)

    def total_fixed_bytes(self) -> int:
        return sum(r.total_fixed() for r in self.layer_reports)

    def total_activation_bytes(self, batch_size: int) -> int:
        return batch_size * sum(r.activation_bytes_per_example
                                for r in self.layer_reports)

    def total_bytes(self, batch_size: int) -> int:
        return (self.total_fixed_bytes()
                + self.total_activation_bytes(batch_size))

    def summary(self, batch_size: int = 32) -> str:
        lines = [f"{'layer':<24}{'type':<22}{'params MB':>12}{'acts MB':>12}"]
        for r in self.layer_reports:
            lines.append(
                f"{r.layer_name:<24}{r.layer_type:<22}"
                f"{r.parameter_bytes / 2**20:>12.3f}"
                f"{batch_size * r.activation_bytes_per_example / 2**20:>12.3f}")
        lines.append(f"TOTAL (batch {batch_size}): "
                     f"{self.total_bytes(batch_size) / 2**20:.2f} MB "
                     f"(fixed {self.total_fixed_bytes() / 2**20:.2f} MB)")
        return "\n".join(lines)


def _updater_slots(updater) -> int:
    """How many param-sized state tensors the updater keeps."""
    name = type(updater).__name__.lower() if updater is not None else "sgd"
    return {"sgd": 0, "noop": 0, "nesterovs": 1, "adagrad": 1, "rmsprop": 1,
            "adadelta": 2, "adam": 2, "adamax": 2, "nadam": 2}.get(name, 2)


def memory_report(conf, dtype_bytes: int = 4) -> NetworkMemoryReport:
    """The `NetworkMemoryReport` of a `MultiLayerConfiguration`."""
    reports = []
    current = conf.input_type
    for i, layer in enumerate(conf.layers):
        n_params = sum(t.numel() for t in layer.jax_param_map().values())
        p_bytes = int(n_params) * dtype_bytes
        out_type = (layer.get_output_type(current) if current is not None
                    else None)
        try:
            act = (int(out_type.arity()) * dtype_bytes
                   if out_type is not None else 0)
        except Exception:  # noqa: BLE001 — a type without a fixed arity
            act = 0
        reports.append(LayerMemoryReport(
            layer_name=getattr(layer, "name", None) or str(i),
            layer_type=type(layer).__name__,
            parameter_bytes=p_bytes,
            updater_state_bytes=p_bytes * _updater_slots(layer.updater),
            activation_bytes_per_example=act))
        current = out_type
    return NetworkMemoryReport(reports, conf.input_type)
