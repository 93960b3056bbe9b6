"""LoRA low-rank adapters over a frozen shared base (counterpart of
`deeplearning4j_tpu/tenancy/lora.py`: `LoRAWeight` :69, `_lora_matmul`
:116, `adapter_weight_keys` :133, `contains_lora` :145, `init_adapter`
:162, `attach_adapter` :200, `extract_adapter` :242, `strip_adapter`
:253, `compose_params` :276, `apply_adapter_update` :294,
`adapter_bytes` :314, `save_adapter`/`load_adapter` :323-369).

The publish unit of the multi-tenant fleet is an adapter delta: a tenant
fine-tunes ``W_eff = W + (alpha / r) * B @ A`` with the base `W` frozen
and ships `{B, A}` alone. Composition happens inside the matmul, never by
materializing `W_eff`:

    x @ W_eff = x @ W + ((x @ B) @ A) * (alpha / r)

in x's dtype (B and A are cast to it, bf16 under `mixed_bf16`), the scale
rounded to x's dtype, through `nd.quant.matmul` (registered there as an
extension, so an int8 base under an fp adapter recurses). The two skinny
products are plain `torch.matmul`, as JAX computes them in XLA.

How the port carries an adapter. The port's layers read their weights
as module attributes through `nd.quant.weight`, so a `LoRAWeight` cannot
replace a param in a tree:

- **Train side** (`attach_adapter`): B and A become `nn.Parameter`s of
  the module that owns the wrapped weight (``<attribute>_lora_B``,
  ``_lora_A``), and the module carries a wrapper of that weight
  (`nd.quant.wrap_weight`) that hands the layer ``LoRAWeight(w, B, A)``
  around whatever it reads (the attribute, a mixed step's compute copy,
  the int8 tree). So `fit`, `functional_call`'s compute copies, remat,
  `.to()` and serving see the factors as ordinary params. A frozen base
  is detached at its read: it gets no gradient. The containers'
  `_apply_updates` keeps every base leaf still when an attached adapter
  is frozen (biases, norms and embeddings too) and moves B and A through
  the layer's updater, Adam's factors as one fused-Adam launch.
- **Serve side** (`compose_serving_tree`): a `quant.ServingTree` whose
  installable maps each adapted weight's (module, attribute) to
  ``LoRAWeight(base leaf, B, A)`` over the base tree's own tensors (fp32
  params, compute copies or int8), so N tenants share one base copy.

`init_adapter` draws A as JAX does: ``normal(fold_in(fold_in(key(seed),
int(lk)), j)) / rank`` with `j` the index of the param key in SORTED
order, and B zeros, so a fresh adapter is an exact no-op. (JAX's
docstring says N(0, 1/r); the code divides the draw by r, not by its
square root, and so does this one.)

The adapter artifact crosses packages: a zip holding `adapter.npz`
("lk::pk__B" / "__A" keys) and `meta.json` (format version, rank, alpha,
base version, per-array crc32 of the C-order bytes).
"""

from __future__ import annotations

import io
import json
import zipfile
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from deeplearning4j_tpu_torch.common import prng
from deeplearning4j_tpu_torch.fault.state import checksum_array as _crc
from deeplearning4j_tpu_torch.nd import quant

ADAPTER_FORMAT_VERSION = 1
_B, _A = "_lora_B", "_lora_A"    # suffixes of the factor params' names


class LoRAWeight:
    """A matmul weight with a low-rank delta: `base` (a tensor or an int8
    `QuantizedTensor`), `B` [n_in, r], `A` [r, n_out], `scale` =
    alpha / r and `frozen` (the base takes no gradient)."""

    __slots__ = ("base", "B", "A", "scale", "frozen", "_scales")

    def __init__(self, base, B, A, scale: float, frozen: bool = True):
        self.base = base
        self.B = B
        self.A = A
        self.scale = float(scale)
        self.frozen = bool(frozen)
        self._scales = {}

    @property
    def shape(self):
        return tuple((self.base.q if isinstance(
            self.base, quant.QuantizedTensor) else self.base).shape)

    @property
    def nbytes(self) -> int:
        base = self.base.nbytes if isinstance(
            self.base, quant.QuantizedTensor) else (
            self.base.numel() * self.base.element_size())
        return base + sum(t.numel() * t.element_size()
                          for t in (self.B, self.A))

    def scale_in(self, dtype):
        """The scale rounded to `dtype`, as ``jnp.asarray(scale, dtype)``
        gives it (a Python float holding that value)."""
        s = self._scales.get(dtype)
        if s is None:
            s = self._scales[dtype] = float(torch.tensor(self.scale,
                                                         dtype=dtype))
        return s

    def __repr__(self):
        return (f"LoRAWeight(shape={self.shape}, r={self.B.shape[-1]}, "
                f"scale={self.scale}, frozen={self.frozen})")


def _lora_matmul(x, w: LoRAWeight):
    """``x @ W_eff`` without materializing it: the base matmul (an int8
    base dequantizes inside) plus the rank-r bottleneck in x's dtype. A
    frozen base is read detached, so it takes no gradient."""
    base = w.base
    if w.frozen and isinstance(base, torch.Tensor):
        base = base.detach()
    y = quant.matmul(x, base)
    delta = torch.matmul(torch.matmul(x, w.B.to(x.dtype)), w.A.to(x.dtype))
    return y + delta * w.scale_in(x.dtype)


quant.register_matmul_extension(LoRAWeight, _lora_matmul)


class _Factors:
    """A module's wrapper of one adapted weight (`quant.wrap_weight`):
    the factors are the module's params ``<attribute>_lora_B`` and
    ``_lora_A``, read at each call, so a mixed step's compute copies and
    `functional_call` reach them."""

    __slots__ = ("attr", "rank", "alpha", "frozen")

    def __init__(self, attr: str, rank: int, alpha: float, frozen: bool):
        self.attr = attr
        self.rank = int(rank)
        self.alpha = float(alpha)
        self.frozen = bool(frozen)

    @property
    def scale(self) -> float:
        return self.alpha / self.rank

    def factors(self, module):
        return (getattr(module, self.attr + _B),
                getattr(module, self.attr + _A))

    def __call__(self, module, base):
        B, A = self.factors(module)
        return LoRAWeight(base, B, A, self.scale, self.frozen)


# ------------------------------------------------------------ tree helpers
def _keyed_layers(net) -> Dict[str, object]:
    return {str(k): layer for k, layer in net.keyed()}


def adapter_weight_keys(net) -> Dict[str, list]:
    """{layer key: [param key, ...]} of every weight the net's layers
    declare adapter-eligible (`Layer.adapter_weights()`)."""
    out = {}
    for key, layer in net.keyed():
        pm = layer.jax_param_map()
        keys = [k for k in layer.adapter_weights() if k in pm]
        if keys:
            out[str(key)] = keys
    return out


def adapter_config(net) -> Optional[dict]:
    """{"rank", "alpha", "frozen"} of the attached adapter, or None."""
    for _, _, wrap in net.adapted.values():
        return {"rank": wrap.rank, "alpha": wrap.alpha,
                "frozen": wrap.frozen}
    return None


def contains_lora(tree) -> bool:
    """True if any node in `tree` is a LoRAWeight."""
    if isinstance(tree, LoRAWeight):
        return True
    if isinstance(tree, dict):
        return any(contains_lora(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(contains_lora(v) for v in tree)
    return False


def init_adapter(net, *, rank: int, seed: int = 0) -> dict:
    """A fresh adapter tree `{lk: {pk: {"B", "A"}}}` on the net's device
    for every adapter-eligible weight: B zeros [n_in, r], A the threefry
    normal draw divided by r [r, n_out], so the delta starts at exactly
    0."""
    if rank < 1:
        raise ValueError(f"adapter rank must be >= 1; got {rank}")
    layers = _keyed_layers(net)
    root = prng.key(seed)
    out: dict = {}
    for lk, keys in adapter_weight_keys(net).items():
        pm = layers[lk].jax_param_map()
        lp = {}
        for j, pk in enumerate(sorted(keys)):
            w = pm[pk]
            n_in, n_out = int(w.shape[-2]), int(w.shape[-1])
            key = prng.fold_in(prng.fold_in(root, int(lk)), j)
            lp[pk] = {
                "B": torch.zeros((n_in, rank), dtype=torch.float32,
                                 device=w.device),
                "A": prng.normal(key, (rank, n_out), torch.float32,
                                 device=w.device) / float(rank),
            }
        out[lk] = lp
    return out


def _check_layer_adaptable(layer, lk):
    if layer.l1 or layer.l2:
        raise ValueError(
            f"layer {lk}: l1/l2 regularization on an adapted layer would "
            f"push gradient into a frozen base — set l1=l2=0 on adapted "
            f"layers")
    if layer.constraints:
        raise ValueError(
            f"layer {lk}: norm constraints are not supported on adapted "
            f"layers (they rescale the raw param, which the adapter "
            f"wraps)")


def _check_net_adaptable(net):
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        GradientNormalization)
    c = net.conf
    if (GradientNormalization(c.gradient_normalization)
            != GradientNormalization.NONE or c.max_norm is not None):
        raise NotImplementedError(
            "gradient normalization and max_norm on an adapted net are "
            "not ported (the adapter factors would be left out of the "
            "layer norms)")


def _factor(t, device) -> torch.Tensor:
    if isinstance(t, torch.Tensor):
        return t.detach().to(device).clone()
    return torch.from_numpy(np.array(t)).to(device)


def attach_adapter(net, adapter: dict, *, rank: int, alpha: float,
                   frozen: bool = True):
    """Wrap the net's adapter-eligible weights named in `adapter`
    (training-side composition): B and A become params of the weight's
    module, the module wraps the weight, and `updater_state[lk][pk]`
    becomes the factors' fresh slots ``{"B": ..., "A": ...}`` (a frozen
    base keeps no slot: it never moves; `frozen=False` adds ``"base"``).
    The base tensors are not copied. The params version moves on, so
    serving trees rebuild. Returns the net."""
    _check_net_adaptable(net)
    layers = _keyed_layers(net)
    for lk, lv in adapter.items():
        layer = layers[str(lk)]
        _check_layer_adaptable(layer, lk)
        pm = layer.jax_param_map()
        for pk, ba in lv.items():
            slot = layer.param_slots()[pk]
            if quant.wrapper_of(*slot) is not None:
                raise ValueError(f"layer {lk} param {pk} already carries "
                                 f"an adapter — strip_adapter() first")
            w, b_, a_ = pm[pk], tuple(ba["B"].shape), tuple(ba["A"].shape)
            if (b_[0], a_[1]) != (w.shape[-2], w.shape[-1]):
                raise ValueError(
                    f"layer {lk} param {pk}: adapter factors {b_}x{a_} "
                    f"don't fit weight {tuple(w.shape)}")
    added = dict(net.adapted)
    for lk, lv in adapter.items():
        layer = layers[str(lk)]
        updater = net.updater_of(layer)
        pm, slots = layer.jax_param_map(), layer.param_slots()
        for pk, ba in lv.items():
            w = pm[pk]
            B, A = _factor(ba["B"], w.device), _factor(ba["A"], w.device)
            module, attr = slots[pk]
            module.register_parameter(attr + _B,
                                      nn.Parameter(B, requires_grad=False))
            module.register_parameter(attr + _A,
                                      nn.Parameter(A, requires_grad=False))
            wrap = _Factors(attr, rank, alpha, frozen)
            quant.wrap_weight(module, attr, wrap)
            added[(str(lk), pk)] = (module, attr, wrap)
            st = {"B": updater.init_state(getattr(module, attr + _B)),
                  "A": updater.init_state(getattr(module, attr + _A))}
            if not frozen:
                st["base"] = updater.init_state(w)
            net.updater_state.setdefault(str(lk), {})[pk] = st
    net.adapted = {(lk, pk): added[(lk, pk)] for lk, layer in layers.items()
                   for pk in layer.adapter_weights() if (lk, pk) in added}
    net.params_changed()
    return net


def extract_adapter(net) -> dict:
    """A copy of the attached adapter tree `{lk: {pk: {"B", "A"}}}`: the
    publish unit (`ModelRegistry.publish_adapter`)."""
    return {lk: {pk: {s: t.detach().clone() for s, t in ba.items()}
                 for pk, ba in lv.items()}
            for lk, lv in net.adapter_factors().items()}


def strip_adapter(net) -> dict:
    """Detach every adapter and return its tree: the factor params leave
    their modules, the weights read plain again, and each adapted
    weight's updater slot is initialised afresh (the pre-attach moments
    are not restored, as in JAX). The params version moves on."""
    adapter: dict = {}
    layers = _keyed_layers(net)
    for (lk, pk), (module, attr, wrap) in net.adapted.items():
        B, A = wrap.factors(module)
        adapter.setdefault(lk, {})[pk] = {"B": B.detach(), "A": A.detach()}
        del module._parameters[attr + _B]
        del module._parameters[attr + _A]
        quant.unwrap_weight(module, attr)
        layer = layers[lk]
        net.updater_state[lk][pk] = net.updater_of(layer).init_state(
            layer.jax_param_map()[pk])
    net.adapted = {}
    net.params_changed()
    return adapter


def compose_params(base_params: dict, adapter: dict, *, rank: int,
                   alpha: float) -> dict:
    """Serving-side composition of a JAX-keyed params tree: the adapted
    leaves become ``LoRAWeight(base leaf, B, A)`` (frozen), sharing the
    base leaf (a param, a compute copy or an int8 `QuantizedTensor`);
    every other leaf is the base tree's own. B and A move to the base's
    device."""
    scale = float(alpha) / float(rank)
    out = {}
    for lk, lv in base_params.items():
        lav = adapter.get(lk, {})
        out[lk] = {}
        for pk, w in lv.items():
            if pk not in lav:
                out[lk][pk] = w
                continue
            dev = (w.q if isinstance(w, quant.QuantizedTensor) else w).device
            out[lk][pk] = LoRAWeight(w, _factor(lav[pk]["B"], dev),
                                     _factor(lav[pk]["A"], dev), scale, True)
    return out


def compose_serving_tree(net, base_tree: "quant.ServingTree", adapter: dict,
                         *, rank: int, alpha: float) -> "quant.ServingTree":
    """`base_tree` (the net's serving tree) with `adapter` composed in:
    its params through `compose_params`, its installable with every
    adapted weight's (id(module), attribute) mapped to that leaf's
    `LoRAWeight`, over the base tree's own tensors."""
    params = compose_params(base_tree.params, adapter, rank=rank,
                            alpha=alpha)
    install = dict(base_tree.installable or {})
    for lk, layer in _keyed_layers(net).items():
        slots = None
        for pk, leaf in params.get(lk, {}).items():
            if isinstance(leaf, LoRAWeight):
                slots = slots or layer.param_slots()
                module, attr = slots[pk]
                install[(id(module), attr)] = leaf
    return quant.ServingTree(params, install or None)


@torch.no_grad()
def apply_adapter_update(updater, p: LoRAWeight, g: dict, slots: dict,
                         step: int):
    """One optimizer step on an adapted weight, in place (the JAX
    `_apply_updates` branch, per leaf): B and A move through `updater`
    from the gradients ``g["B"]``, ``g["A"]`` (upcast to the factors'
    dtype); a frozen base, or one without a ``"base"`` slot, is not
    touched, else it moves from ``g["base"]``."""
    for name in ("B", "A"):
        t = getattr(p, name)
        upd, new = updater.apply(g[name].to(t.dtype), slots[name], step)
        t.sub_(upd.to(t.dtype))
        slots[name].update(new)
    if not p.frozen and "base" in slots:
        upd, new = updater.apply(g["base"].to(p.base.dtype), slots["base"],
                                 step)
        p.base.sub_(upd.to(p.base.dtype))
        slots["base"].update(new)


def adapter_bytes(adapter: dict) -> int:
    """Bytes of the adapter tree's factors."""
    return sum(int(np.prod(tuple(t.shape))) * (
        t.element_size() if isinstance(t, torch.Tensor)
        else np.asarray(t).itemsize)
        for lv in adapter.values() for ba in lv.values()
        for t in ba.values())


# ------------------------------------------------------------------ serde
def _host(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def save_adapter(path: Union[str, Path, io.IOBase], adapter: dict, *,
                 meta: Optional[dict] = None):
    """Write the adapter artifact: a zip of `adapter.npz` ("lk::pk__B"
    keys) and `meta.json` (format version, the caller's `meta` such as
    rank, alpha and base version, per-array crc32), the format the JAX
    package reads."""
    flat = {}
    for lk, lv in adapter.items():
        for pk, ba in lv.items():
            flat[f"{lk}::{pk}__B"] = _host(ba["B"])
            flat[f"{lk}::{pk}__A"] = _host(ba["A"])
    m = dict(meta or {})
    m.setdefault("format_version", ADAPTER_FORMAT_VERSION)
    m["array_checksums"] = {k: _crc(a) for k, a in flat.items()}
    buf = io.BytesIO()
    np.savez(buf, **flat)
    target = path if hasattr(path, "write") else str(path)
    with zipfile.ZipFile(target, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("adapter.npz", buf.getvalue())
        zf.writestr("meta.json", json.dumps(m, indent=2))


def load_adapter(path: Union[str, Path, io.IOBase]):
    """-> (adapter tree of CPU tensors, meta). Verifies every array's
    crc32 the artifact carries; raises ValueError on a mismatch."""
    src = path if hasattr(path, "read") else str(path)
    with zipfile.ZipFile(src, "r") as zf:
        meta = json.loads(zf.read("meta.json"))
        with zf.open("adapter.npz") as f:
            data = np.load(io.BytesIO(f.read()))
            flat = {k: data[k] for k in data.files}
    expected = meta.get("array_checksums") or {}
    bad = [k for k, arr in flat.items()
           if k in expected and _crc(arr) != expected[k]]
    if bad:
        raise ValueError(
            f"adapter artifact failed checksum verification: {bad[:5]}")
    out: dict = {}
    for key, arr in flat.items():
        lp, slot = key.rsplit("__", 1)
        lk, pk = lp.split("::", 1)
        out.setdefault(lk, {}).setdefault(pk, {})[slot] = torch.from_numpy(
            np.array(arr))
    return out, meta
