"""Dtype policy: mixed-precision training (counterpart of
`deeplearning4j_tpu/nd/dtype.py`: `DataTypePolicy` :45, the process
default :132-172, `mixed_bf16` :175, `policy_from_name` :197,
`as_policy` :206, `env_policy` :218, `resolve_policy` :233).

A policy splits three dtypes: `param_dtype` (the master copy of the
params and the updater state), `compute_dtype` (activations, the
backward, and so the gradients) and `output_dtype` (the output layer's
loss and `output()`). `mixed_bf16` is fp32 / bf16 / fp32. The containers
(`nn/container.py`) make one compute-dtype copy of each floating
param per step and differentiates that copy, so the gradients arrive in
bf16 and the updater upcasts them onto the fp32 master; norm statistics
stay fp32 inside the LayerNorm kernel. The casts are explicit (no
autocast).

Resolution, as in the JAX package: the ``DL4J_DTYPE_POLICY``
environment variable wins, then the explicit argument, then a
configuration's ``dtype_policy`` field, then the process default
(`set_default_dtype` / `set_default_policy`, factory float32).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

_ENV_VAR = "DL4J_DTYPE_POLICY"

_BY_NAME = {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16, "float64": torch.float64}


def as_dtype(d) -> torch.dtype:
    """A torch floating dtype from a torch dtype or a name ("float32",
    "bfloat16", ... as the JAX package writes them)."""
    if isinstance(d, torch.dtype):
        return d
    name = getattr(d, "name", None) or str(d)
    name = name.removeprefix("torch.")
    if name not in _BY_NAME:
        raise ValueError(f"unknown dtype {d!r}; known: {sorted(_BY_NAME)}")
    return _BY_NAME[name]


def dtype_name(d) -> str:
    return str(as_dtype(d)).removeprefix("torch.")


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


@dataclasses.dataclass(frozen=True)
class DataTypePolicy:
    """Param / compute / output dtype split (fields accept torch dtypes
    or their names)."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        for f in ("param_dtype", "compute_dtype", "output_dtype"):
            object.__setattr__(self, f, as_dtype(getattr(self, f)))

    # ------------------------------------------------------------- queries
    @property
    def is_mixed(self) -> bool:
        """True when compute runs in another precision than the master
        copy: the policies that change what the container runs."""
        return self.compute_dtype != self.param_dtype

    @property
    def name(self) -> str:
        f32, bf16 = torch.float32, torch.bfloat16
        if (self.param_dtype, self.compute_dtype, self.output_dtype) == (
                f32, f32, f32):
            return "float32"
        if (self.param_dtype, self.compute_dtype, self.output_dtype) == (
                f32, bf16, f32):
            return "mixed_bf16"
        return "custom"

    # --------------------------------------------------------------- casts
    def cast_compute(self, x):
        """One tensor to the compute dtype. Non-floating inputs (token
        ids, bool masks) pass UNCHANGED: a bf16 cast would corrupt ids
        above 256."""
        if _is_float(x) and x.dtype != self.compute_dtype:
            return x.to(self.compute_dtype)
        return x

    def cast_output(self, x):
        if _is_float(x) and x.dtype != self.output_dtype:
            return x.to(self.output_dtype)
        return x

    def cast_params(self, tree):
        """A tree (dicts, lists) of tensors to the compute dtype, floating
        leaves only. The SAME tree object for a non-mixed policy."""
        if not self.is_mixed:
            return tree
        return _tree_map(self.cast_compute, tree)

    def cast_output_params(self, tree):
        """Output-layer params to the output dtype (the loss stays fp32
        under a mixed policy). Identity when not mixed."""
        if not self.is_mixed:
            return tree
        return _tree_map(self.cast_output, tree)

    # --------------------------------------------------------------- serde
    def to_dict(self) -> dict:
        return {"param_dtype": dtype_name(self.param_dtype),
                "compute_dtype": dtype_name(self.compute_dtype),
                "output_dtype": dtype_name(self.output_dtype)}

    @staticmethod
    def from_dict(d: dict) -> "DataTypePolicy":
        return DataTypePolicy(
            param_dtype=d.get("param_dtype", "float32"),
            compute_dtype=d.get("compute_dtype", "float32"),
            output_dtype=d.get("output_dtype", "float32"))


_FACTORY = DataTypePolicy()
_DEFAULT = _FACTORY


def default_policy() -> DataTypePolicy:
    return _DEFAULT


def get_default_policy() -> DataTypePolicy:
    """The active process-default policy."""
    return _DEFAULT


def get_default_dtype() -> torch.dtype:
    """Param (master) dtype of the active policy."""
    return _DEFAULT.param_dtype


def set_default_dtype(param_dtype=None, compute_dtype=None,
                      output_dtype=None, *, reset: bool = False):
    """Process-default policy override (`Nd4j.setDataType`). Unset fields
    keep their values; ``reset=True`` starts from the factory float32
    policy."""
    global _DEFAULT
    base = _FACTORY if reset else _DEFAULT
    _DEFAULT = DataTypePolicy(
        param_dtype=param_dtype or base.param_dtype,
        compute_dtype=compute_dtype or base.compute_dtype,
        output_dtype=output_dtype or base.output_dtype)
    return _DEFAULT


def set_default_policy(policy: Optional[DataTypePolicy] = None):
    """Install `policy` as the process default (None: factory float32)."""
    global _DEFAULT
    _DEFAULT = policy if policy is not None else _FACTORY
    return _DEFAULT


def mixed_bf16() -> DataTypePolicy:
    """fp32 master params / bf16 compute / fp32 losses."""
    return DataTypePolicy(compute_dtype=torch.bfloat16)


def bf16_policy() -> DataTypePolicy:
    """Alias of `mixed_bf16()`."""
    return mixed_bf16()


_NAMED = {
    "float32": DataTypePolicy,
    "fp32": DataTypePolicy,
    "mixed_bf16": mixed_bf16,
    "bf16": mixed_bf16,
}


def policy_from_name(name: str) -> DataTypePolicy:
    key = str(name).strip().lower()
    if key not in _NAMED:
        raise ValueError(f"unknown dtype policy {name!r}; known: "
                         f"{sorted(_NAMED)}")
    return _NAMED[key]()


def as_policy(p) -> Optional[DataTypePolicy]:
    """A policy object, preset name, serde dict or None as a
    DataTypePolicy (or None)."""
    if p is None or isinstance(p, DataTypePolicy):
        return p
    if isinstance(p, str):
        return policy_from_name(p)
    if isinstance(p, dict):
        return DataTypePolicy.from_dict(p)
    raise TypeError(f"cannot interpret {p!r} as a dtype policy")


def env_policy() -> Optional[DataTypePolicy]:
    """The ``DL4J_DTYPE_POLICY`` override if set, else None.
    ``0/off/false/no`` force float32, ``1/on/true/yes`` mixed_bf16, and
    preset names select presets."""
    env = os.environ.get(_ENV_VAR)
    if env is None or not env.strip():
        return None
    v = env.strip().lower()
    if v in ("0", "off", "false", "no"):
        return DataTypePolicy()
    if v in ("1", "on", "true", "yes"):
        return mixed_bf16()
    return policy_from_name(v)


def resolve_policy(explicit=None, conf=None) -> DataTypePolicy:
    """``DL4J_DTYPE_POLICY`` wins, then `explicit`, then
    ``conf.dtype_policy``, then the process default."""
    forced = env_policy()
    if forced is not None:
        return forced
    explicit = as_policy(explicit)
    if explicit is not None:
        return explicit
    conf_p = as_policy(getattr(conf, "dtype_policy", None))
    if conf_p is not None:
        return conf_p
    return _DEFAULT
