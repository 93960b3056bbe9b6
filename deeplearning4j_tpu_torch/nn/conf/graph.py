"""Graph vertices of a ComputationGraph (counterpart of
`deeplearning4j_tpu/nn/conf/graph.py`, the whole module): each vertex is
a function of its input tensors without params, with its output type,
its mask rule and the JAX serde (`to_dict()` equal to the JAX vertex's,
`vertex_from_dict` reading either package's dicts).

Features and channels are the LAST axis for FF [B, F], RNN [B, T, F]
and NHWC CNN activations alike, as in the JAX package, so the
concatenating and slicing vertices work on axis -1.
`PreprocessorVertex` wraps an input preprocessor, whose forward raises
until the preprocessors' forward is ported (`nn/conf/preprocessors.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import (
    InputType,
    InputTypeConvolutional,
    InputTypeFeedForward,
    InputTypeRecurrent,
)

_VERTEX_REGISTRY: Dict[str, type] = {}


def register_vertex(cls):
    _VERTEX_REGISTRY[cls.vertex_name] = cls
    return cls


class GraphVertex:
    vertex_name = "base"

    def forward(self, inputs: List[torch.Tensor], masks=None,
                train: bool = False):
        raise NotImplementedError

    def get_output_type(self, input_types: List[InputType]) -> InputType:
        return input_types[0]

    def forward_mask(self, masks):
        """The first input's mask that is not None (None without one)."""
        for m in masks or []:
            if m is not None:
                return m
        return None

    def to_dict(self):
        d = {"vertex": self.vertex_name}
        if dataclasses.is_dataclass(self):
            d.update(dataclasses.asdict(self))
        return d

    def __eq__(self, other):
        return type(self) is type(other) and self.__dict__ == other.__dict__


def vertex_from_dict(d: dict) -> GraphVertex:
    d = dict(d)
    name = d.pop("vertex")
    if name == "preprocessor":
        from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
            preprocessor_from_dict)
        return PreprocessorVertex(preprocessor_from_dict(d["preprocessor"]))
    return _VERTEX_REGISTRY[name](**d)


def _fold(fn, inputs):
    out = inputs[0]
    for x in inputs[1:]:
        out = fn(out, x)
    return out


@register_vertex
@dataclasses.dataclass(eq=False)
class ElementWiseVertex(GraphVertex):
    """Pointwise add, subtract (two inputs), product, average or max."""

    op: str = "add"
    vertex_name = "elementwise"

    def forward(self, inputs, masks=None, train=False):
        op = self.op.lower()
        if op == "add":
            return _fold(torch.add, inputs)
        if op == "subtract":
            if len(inputs) != 2:
                raise ValueError("subtract needs exactly 2 inputs")
            return inputs[0] - inputs[1]
        if op == "product":
            return _fold(torch.mul, inputs)
        if op == "average":
            return _fold(torch.add, inputs) / len(inputs)
        if op == "max":
            return _fold(torch.maximum, inputs)
        raise ValueError(f"Unknown elementwise op {self.op}")


@register_vertex
@dataclasses.dataclass(eq=False)
class MergeVertex(GraphVertex):
    """Concatenation along the feature/channel axis (-1)."""

    vertex_name = "merge"

    def forward(self, inputs, masks=None, train=False):
        return torch.cat(inputs, dim=-1)

    def get_output_type(self, input_types):
        t0 = input_types[0]
        if isinstance(t0, InputTypeFeedForward):
            return InputType.feed_forward(sum(t.size for t in input_types))
        if isinstance(t0, InputTypeRecurrent):
            return InputType.recurrent(sum(t.size for t in input_types),
                                       t0.timesteps)
        if isinstance(t0, InputTypeConvolutional):
            return InputType.convolutional(
                t0.height, t0.width, sum(t.channels for t in input_types))
        return t0


@register_vertex
@dataclasses.dataclass(eq=False)
class SubsetVertex(GraphVertex):
    """Features [from_idx, to_idx], both inclusive."""

    from_idx: int = 0
    to_idx: int = 0
    vertex_name = "subset"

    def forward(self, inputs, masks=None, train=False):
        return inputs[0][..., self.from_idx:self.to_idx + 1]

    def get_output_type(self, input_types):
        size = self.to_idx - self.from_idx + 1
        t0 = input_types[0]
        if isinstance(t0, InputTypeRecurrent):
            return InputType.recurrent(size, t0.timesteps)
        return InputType.feed_forward(size)


def _per_example_sum_sq(x):
    return (x * x).sum(dim=tuple(range(1, x.ndim)))


@register_vertex
@dataclasses.dataclass(eq=False)
class L2Vertex(GraphVertex):
    """L2 distance between two inputs per example, [B, 1]."""

    eps: float = 1e-8
    vertex_name = "l2"

    def forward(self, inputs, masks=None, train=False):
        a, b = inputs
        return torch.sqrt(_per_example_sum_sq(a - b) + self.eps)[:, None]

    def get_output_type(self, input_types):
        return InputType.feed_forward(1)


@register_vertex
@dataclasses.dataclass(eq=False)
class L2NormalizeVertex(GraphVertex):
    """x / ||x||_2 per example."""

    eps: float = 1e-8
    vertex_name = "l2_normalize"

    def forward(self, inputs, masks=None, train=False):
        x = inputs[0]
        norm = torch.sqrt(_per_example_sum_sq(x) + self.eps)
        return x / norm.reshape((-1,) + (1,) * (x.ndim - 1))


@register_vertex
@dataclasses.dataclass(eq=False)
class ScaleVertex(GraphVertex):
    scale_factor: float = 1.0
    vertex_name = "scale"

    def forward(self, inputs, masks=None, train=False):
        return inputs[0] * self.scale_factor


@register_vertex
@dataclasses.dataclass(eq=False)
class ShiftVertex(GraphVertex):
    shift_factor: float = 0.0
    vertex_name = "shift"

    def forward(self, inputs, masks=None, train=False):
        return inputs[0] + self.shift_factor


@register_vertex
@dataclasses.dataclass(eq=False)
class ReshapeVertex(GraphVertex):
    """Reshape to [batch, *new_shape]."""

    new_shape: Any = None
    vertex_name = "reshape"

    def forward(self, inputs, masks=None, train=False):
        x = inputs[0]
        return x.reshape((x.shape[0],) + tuple(self.new_shape))

    def get_output_type(self, input_types):
        shape = tuple(self.new_shape)
        if len(shape) == 1:
            return InputType.feed_forward(shape[0])
        if len(shape) == 2:
            return InputType.recurrent(shape[1], shape[0])
        if len(shape) == 3:
            return InputType.convolutional(shape[0], shape[1], shape[2])
        return input_types[0]


@register_vertex
@dataclasses.dataclass(eq=False)
class StackVertex(GraphVertex):
    """Inputs stacked along the BATCH axis (shared-weight towers)."""

    vertex_name = "stack"

    def forward(self, inputs, masks=None, train=False):
        return torch.cat(inputs, dim=0)


@register_vertex
@dataclasses.dataclass(eq=False)
class UnstackVertex(GraphVertex):
    """Chunk `from_idx` of `stack_size` equal batch chunks."""

    from_idx: int = 0
    stack_size: int = 1
    vertex_name = "unstack"

    def forward(self, inputs, masks=None, train=False):
        x = inputs[0]
        step = x.shape[0] // self.stack_size
        return x[self.from_idx * step:(self.from_idx + 1) * step]


@register_vertex
@dataclasses.dataclass(eq=False)
class LastTimeStepVertex(GraphVertex):
    """[B, T, F] -> [B, F] at the last unmasked step (the last step
    without a mask); the mask stops here."""

    vertex_name = "last_time_step"

    def forward(self, inputs, masks=None, train=False):
        x = inputs[0]
        mask = masks[0] if masks else None
        if mask is None:
            return x[:, -1, :]
        idx = torch.clamp(mask.to(torch.int64).sum(dim=1) - 1, min=0)
        return x[torch.arange(x.shape[0], device=x.device), idx]

    def get_output_type(self, input_types):
        return InputType.feed_forward(input_types[0].size)

    def forward_mask(self, masks):
        return None


@register_vertex
@dataclasses.dataclass(eq=False)
class DuplicateToTimeSeriesVertex(GraphVertex):
    """[B, F] -> [B, T, F], T taken from the second input's time axis."""

    vertex_name = "duplicate_to_time_series"

    def forward(self, inputs, masks=None, train=False):
        x, time_ref = inputs[0], inputs[1]
        return x[:, None, :].expand(x.shape[0], time_ref.shape[1],
                                    x.shape[-1])

    def get_output_type(self, input_types):
        t = (input_types[1].timesteps
             if isinstance(input_types[1], InputTypeRecurrent) else None)
        return InputType.recurrent(input_types[0].arity(), t)


@register_vertex
@dataclasses.dataclass(eq=False)
class PreprocessorVertex(GraphVertex):
    """An input preprocessor as a vertex."""

    preprocessor: Any = None
    vertex_name = "preprocessor"

    def forward(self, inputs, masks=None, train=False):
        return self.preprocessor.pre_process(inputs[0])

    def get_output_type(self, input_types):
        return self.preprocessor.get_output_type(input_types[0])

    def to_dict(self):
        return {"vertex": self.vertex_name,
                "preprocessor": self.preprocessor.to_dict()}


@register_vertex
@dataclasses.dataclass(eq=False)
class PoolHelperVertex(GraphVertex):
    """NHWC activations without their first row and column (the JAX
    vertex delegates to `nn.layers.misc.PoolHelperLayer`, a GoogLeNet
    shim)."""

    vertex_name = "pool_helper"

    def forward(self, inputs, masks=None, train=False):
        return inputs[0][:, 1:, 1:, :]

    def get_output_type(self, input_types):
        t = input_types[0]
        return InputType.convolutional(t.height - 1, t.width - 1, t.channels)
