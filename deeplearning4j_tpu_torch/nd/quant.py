"""Int8 weight-only serving and the serving-weights seam (counterpart of
`deeplearning4j_tpu/nd/quant.py`: `QuantizedTensor` :56, `quantize`
:97, `dequantize` :119, `register_matmul_extension` :133, `matmul`
:143, `quantized_weight_keys` :160, `quantize_net_params` :172,
`serving_params` :190, `weight_bytes` :211).

Scheme, as in JAX: per-output-channel symmetric int8,
``scale[c] = max|W[:, c]| / 127`` (fp32, keepdims; an all-zero channel
gets 1/127) and ``q = clip(round(W / scale), -127, 127)`` with
`torch.round` (half to even, as `jnp.round`). The product dequantizes
after the contraction: ``(x @ q.to(x.dtype)) * scale.to(x.dtype)``.
The int8 product is a plain `torch.matmul` (the JAX package computes it
in XLA, not in a Pallas kernel).

The seam. The port's layers read their weights as module attributes,
and `torch.func.functional_call` can install tensors only, so a
`QuantizedTensor` cannot ride it. Instead every weight read on the
decode path goes through `weight(module, name)`, which looks the weight
up in the serving tree installed for the current thread and context
(`installed(tree)`, a `contextvars.ContextVar`) and falls back to the
attribute. The container builds the tree (`serving_params`): int8 for
the declared matmul weights (`Layer.quantizable_weights()`, the JAX
keys), and under a mixed dtype policy every floating leaf in the
compute dtype (a `QuantizedTensor`'s scale too; its `q` stays int8, as
JAX's `cast_params` tree-map gives). Nothing is installed for an fp32
net without quantization, so that path reads the attributes unchanged.
Because the tree is per context, a server thread decoding int8 and
another thread calling `output()` never see each other's weights.

Weight wrappers. Other weight types (the LoRA adapter node of
`tenancy/lora.py`) register their own matmul with
`register_matmul_extension`, as in JAX, so every layer seam composes
them (an int8 base under an fp adapter recurses through `matmul`). A
module may also carry a wrapper of one of its weights (`wrap_weight`,
what `tenancy.lora.attach_adapter` installs): `weight` then hands the
layer the wrapper around whatever it would have read (the attribute,
the installed compute copy or int8 tree, the weight noise), unless that
is already an extension type (a composed serving tree's own node).

The tree is cached on the net under its params version
(`MultiLayerNetwork.params_version`, which every write of the params
bumps: `fit`'s updates, `restore_model`, `util.jax_params` loading,
`load_state_dict`, `init`, `to`). The JAX package keys the same cache on
the identity of `net.params`, which every fit replaces; the port updates
its params in place, so identity would serve stale weights.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Optional

import numpy as np
import torch

INT8_MAX = 127
MODES = ("int8",)

_INSTALLED: contextvars.ContextVar = contextvars.ContextVar(
    "serving_weights", default=None)


class QuantizedTensor:
    """A per-output-channel symmetric int8 weight: `q` int8 with the
    weight's shape, `scale` broadcastable over the last axis (keepdims),
    fp32 (or the compute dtype in a mixed serving tree)."""

    __slots__ = ("q", "scale")

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        self.q = q
        self.scale = scale

    @property
    def nbytes(self) -> int:
        return (self.q.numel() * self.q.element_size()
                + self.scale.numel() * self.scale.element_size())

    def to(self, scale_dtype) -> "QuantizedTensor":
        """The same weight with its scale cast to `scale_dtype`."""
        return QuantizedTensor(self.q, self.scale.to(scale_dtype))

    def __repr__(self):
        return (f"QuantizedTensor(shape={tuple(self.q.shape)}, "
                f"q={self.q.dtype}, scale={self.scale.dtype})")


def quantize(w: torch.Tensor, *, axis: int = -1) -> QuantizedTensor:
    """Per-output-channel symmetric int8 quantization of a matmul weight;
    `axis` is the output-channel axis (last, for the `[n_in, n_out]`
    layout)."""
    if w.ndim < 2:
        raise ValueError(
            f"quantize() wants a matmul weight (ndim >= 2); got shape "
            f"{tuple(w.shape)} — biases/gains stay floating")
    axis = axis % w.ndim
    reduce = tuple(i for i in range(w.ndim) if i != axis)
    w32 = w.detach().float()
    amax = w32.abs().amax(dim=reduce, keepdim=True)
    scale = torch.where(amax > 0, amax, torch.ones_like(amax)) / INT8_MAX
    q = torch.clamp(torch.round(w32 / scale), -INT8_MAX, INT8_MAX)
    return QuantizedTensor(q.to(torch.int8), scale)


def dequantize(t: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    """The fp weight (tests; the matmul seam scales after the product)."""
    return (t.q.float() * t.scale.float()).to(dtype)


# weight-wrapper extension point: [(class, fn(x, w))], dispatched after
# `QuantizedTensor`; plain tensors never reach the loop
_MATMUL_EXTENSIONS: list = []
_WRAPPERS = "_weight_wrappers"   # a module's {attribute: wrap(module, w)}


def register_matmul_extension(cls, fn):
    """Register `fn(x, w)` for weights of type `cls` in the `matmul`
    seam. The last registration of a class wins (idempotent under module
    reload)."""
    global _MATMUL_EXTENSIONS
    _MATMUL_EXTENSIONS = [(c, f) for c, f in _MATMUL_EXTENSIONS
                          if c is not cls]
    _MATMUL_EXTENSIONS.append((cls, fn))


def is_extension(w) -> bool:
    """True when `w` is of a registered weight-wrapper type."""
    return any(isinstance(w, c) for c, _ in _MATMUL_EXTENSIONS)


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w``, dequantizing after the contraction when `w` is a
    `QuantizedTensor`, through its registered matmul when `w` is an
    extension type (the seam every quantizable layer matmul takes)."""
    if isinstance(w, QuantizedTensor):
        return torch.matmul(x, w.q.to(x.dtype)) * w.scale.to(x.dtype)
    for cls, fn in _MATMUL_EXTENSIONS:
        if isinstance(w, cls):
            return fn(x, w)
    return torch.matmul(x, w)


# ------------------------------------------------------------ the seam
def weight(module, name: str):
    """`module`'s weight `name` as the installed serving tree holds it
    (a compute-dtype copy, a `QuantizedTensor` or an extension node),
    else the attribute; inside the module's wrapper of `name`, when it
    has one."""
    t = None
    tree = _INSTALLED.get()
    if tree is not None:
        t = tree.get((id(module), name))
    if t is None:
        t = getattr(module, name)
    wrappers = module.__dict__.get(_WRAPPERS)
    if wrappers:
        wrap = wrappers.get(name)
        if wrap is not None and not is_extension(t):
            return wrap(module, t)
    return t


def wrap_weight(module, name: str, wrap):
    """Make `weight(module, name)` return ``wrap(module, w)`` around the
    weight `w` it reads."""
    module.__dict__.setdefault(_WRAPPERS, {})[name] = wrap


def unwrap_weight(module, name: str):
    """Drop `module`'s wrapper of `name`."""
    wrappers = module.__dict__.get(_WRAPPERS) or {}
    wrappers.pop(name, None)
    if not wrappers:
        module.__dict__.pop(_WRAPPERS, None)


def wrapper_of(module, name: str):
    """`module`'s wrapper of `name`, or None."""
    return (module.__dict__.get(_WRAPPERS) or {}).get(name)


@contextlib.contextmanager
def installed(tree: Optional[Dict]):
    """Install `tree` ({(id(module), attribute): weight}, or None for
    none) for the weight reads inside the block, in this context only."""
    if tree is None:
        yield
        return
    token = _INSTALLED.set(tree)
    try:
        yield
    finally:
        _INSTALLED.reset(token)


def overlaid(entries: Dict):
    """Context manager: `entries` ({(id(module), attribute): weight})
    installed over the current tree for the block (the container's
    weight noise while training)."""
    return installed({**(_INSTALLED.get() or {}), **entries})


# ------------------------------------------------------- net-level trees
def quantized_weight_keys(net) -> Dict[str, list]:
    """{layer key: [param key, ...]} of every weight the net's layers
    declare quantizable (`Layer.quantizable_weights()`), JAX keys."""
    out = {}
    for i, layer in enumerate(net.layers):
        pmap = layer.jax_param_map()
        keys = [k for k in layer.quantizable_weights() if k in pmap]
        if keys:
            out[str(i)] = keys
    return out


def quantize_net_params(net, mode: str = "int8") -> Dict[str, dict]:
    """A quantized copy of the net's params as the JAX tree
    ({layer: {key: QuantizedTensor | tensor}}): every declared matmul
    weight int8 with an fp32 scale, everything else the param itself.
    The params are never touched."""
    if mode not in MODES:
        raise ValueError(f"unknown quantization mode {mode!r}; supported: "
                         f"'int8'")
    plan = quantized_weight_keys(net)
    return {str(i): {k: (quantize(p) if k in plan.get(str(i), ()) else p)
                     for k, p in layer.jax_param_map().items()}
            for i, layer in enumerate(net.layers) if layer.jax_param_map()}


class ServingTree:
    """What the serving programs read at one params version: `params`,
    the JAX-keyed tree (policy-cast, quantized), and `installable`, the
    same leaves keyed (id(module), attribute) for `installed`, or None
    when nothing differs from the module attributes."""

    __slots__ = ("params", "installable")

    def __init__(self, params, installable):
        self.params = params
        self.installable = installable


def _build_serving_tree(net, mode: Optional[str]) -> ServingTree:
    cd, mixed = net.dtype.compute_dtype, net.dtype.is_mixed
    src = quantize_net_params(net, mode) if mode is not None else {
        str(i): dict(layer.jax_param_map())
        for i, layer in enumerate(net.layers) if layer.jax_param_map()}
    owner = {id(p): (id(m), n) for m in net.modules()
             for n, p in m._parameters.items() if p is not None}
    params, install = {}, {}
    for lk, lparams in src.items():
        layer = net.layers[int(lk)]
        out = {}
        for k, t in lparams.items():
            p = layer.jax_param_map()[k]
            if isinstance(t, QuantizedTensor):
                if mixed:
                    t = t.to(cd)
            elif mixed and t.is_floating_point():
                t = t.detach().to(cd)
            else:
                out[k] = t
                continue
            out[k] = t
            install[owner[id(p)]] = t
        params[lk] = out
    return ServingTree(params, install or None)


def serving_params(net, quantize_mode: Optional[str]) -> ServingTree:
    """The serving tree of `net` for `quantize_mode` (None or "int8"),
    built once per params version and mode and cached on the net (one
    compute-dtype copy and one quantization pass per version, shared by
    prefill, decode, the score and the drafter). An object whose class
    defines `serving_params` (a tenant's view of a shared base,
    `tenancy/fleet.py`) supplies its own tree."""
    if quantize_mode is not None and quantize_mode not in MODES:
        raise ValueError(f"unknown quantization mode {quantize_mode!r}; "
                         f"supported: 'int8'")
    if getattr(type(net), "serving_params", None) is not None:
        return net.serving_params(quantize_mode)
    cache = net.__dict__.get("_serving_params_cache")
    if cache is None or cache["version"] != net.params_version:
        cache = net.__dict__["_serving_params_cache"] = {
            "version": net.params_version, "trees": {}}
    trees = cache["trees"]
    if quantize_mode not in trees:
        trees[quantize_mode] = _build_serving_tree(net, quantize_mode)
    return trees[quantize_mode]


def serving(net, quantize_mode: Optional[str]):
    """Context manager: the serving weights of `net` installed for the
    block (nothing for an fp32 net without quantization)."""
    return installed(serving_params(net, quantize_mode).installable)


def weight_bytes(params_tree) -> int:
    """Bytes of every weight leaf of a JAX-keyed params tree (a
    `QuantizedTensor` counts q + scale, an extension node its own
    `nbytes`: a LoRA node its base and factors)."""
    total = 0
    for lparams in params_tree.values():
        for t in lparams.values():
            if isinstance(t, QuantizedTensor) or is_extension(t):
                total += t.nbytes
            else:
                total += int(np.prod(t.shape)) * t.element_size()
    return total
