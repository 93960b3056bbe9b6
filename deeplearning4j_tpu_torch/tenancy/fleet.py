"""TenantFleet: N tenants served from one base model held once on the
device (counterpart of `deeplearning4j_tpu/tenancy/fleet.py`:
`_TenantNetView` :48, `TenantFleet` :72, `composed_params` :108,
`shared_base_copies` :130, `_release_version` :151, `_build_server`
:154, `stop` :207).

Every tenant is a `FleetServer` deployment (its own `GenerationServer`,
hot-swap lock and gauges), but what a deployment resolves is an ADAPTER
version from the tenant's adapter store (`ModelRegistry.resolve_adapter`)
composed over one shared base net:

- **One base copy.** The base is resolved once at construction (and
  pinned). Each tenant's engine reads a composed `quant.ServingTree`
  (`lora.compose_serving_tree`): for every adapted weight its
  installable maps (id(module), attribute) to ``LoRAWeight(base leaf,
  B, A)`` over the base serving tree's own tensors (the fp32 params, or
  the int8 copy under ``quantize="int8"``, quantized once and shared), so
  composing a tenant allocates its factors and nothing else.
  `shared_base_copies()` checks it by the base tensors' `data_ptr()`s.
- **The composed cache** holds a tree per (tenant, adapter version),
  keyed on (the base net's `params_version`, the quantize mode). The
  port writes params in place, so a fit or restore of the base moves its
  version, never its identity: a cache keyed on identity would compose
  the stale tree (JAX keys on the identity of `base_net.params`, which
  its fits replace). Every dispatch resolves its tree through the cache,
  so a swap's incumbent and successor each keep their own entry, and a
  released version's entry is dropped.
- **Per-tenant hot swap = adapter pointer flip.** `swap(tenant)` is the
  inherited discipline (warm, flip, move the queue, drain the incumbent);
  the successor differs from the incumbent only in its factors. Streams
  in flight finish on the adapter version they started with; retention
  never collects a served adapter (`pin_adapter` before resolve,
  released through the `_release_version` seam).

A tenant server's net is a `_TenantNetView`: the base net's layers,
configuration and device, with `serving_params` returning the tenant's
composed tree (`nd.quant.serving_params` defers to it). JAX's view also
aliases the base net's jit caches into the view; the port compiles
nothing per server, so it has no counterpart.
"""

from __future__ import annotations

import threading
from typing import Optional

from deeplearning4j_tpu_torch.nd import quant
from deeplearning4j_tpu_torch.serving.fleet import FleetServer
from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
from deeplearning4j_tpu_torch.serving.server import GenerationServer
from deeplearning4j_tpu_torch.tenancy import lora


class _TenantNetView:
    """A tenant's view of the shared base net: its serving weights are
    `tree_of(quantize_mode)` (the composed tree), everything else — the
    layers, configuration, dtype policy, device, forward — is the base
    net's. The engine and `generate()` treat it as a net."""

    def __init__(self, base_net, tree_of):
        self.__dict__["_base_net"] = base_net
        self.__dict__["_tree_of"] = tree_of

    def serving_params(self, quantize_mode):
        return self._tree_of(quantize_mode)

    def __getattr__(self, name):
        return getattr(self.__dict__["_base_net"], name)


def _ptr(t) -> int:
    return (t.q if isinstance(t, quant.QuantizedTensor) else t).data_ptr()


class TenantFleet(FleetServer):
    """FleetServer whose deployment names are TENANTS of one shared base
    model: deploy, swap, scale, undeploy, the gauges, the drain
    discipline and the router interface (`has`/`active`/`names`) are
    inherited; only what a version means (a tenant's adapter version)
    and what a server is built from (the composed shared base) change.
    The base and every server live on `device` (the card unless the
    caller asks for the CPU)."""

    def __init__(self, registry: ModelRegistry, model: str, *,
                 base_version="latest", quantize: Optional[str] = None,
                 gauge_interval_s: float = 0.25, device="cuda"):
        super().__init__(registry, gauge_interval_s=gauge_interval_s,
                         device=device)
        self.model = model
        self.quantize = quantize
        target = (registry.latest(model) if base_version == "latest"
                  else int(base_version))
        if target is None:
            raise FileNotFoundError(
                f"no published versions of {model!r} to base a tenant "
                f"fleet on")
        registry.pin(model, target)
        try:
            self.base_net, self.base_version = registry.resolve(
                model, base_version, device=self.device)
            if self.base_version != target:
                registry.pin(model, self.base_version)
                registry.unpin(model, target)
        except Exception:
            registry.unpin(model, target)
            raise
        # {(tenant, adapter v): {"key": (base params_version, mode),
        #  "tree": composed ServingTree}}
        self._composed_cache: dict = {}
        self._compose_lock = threading.Lock()

    # ------------------------------------------------------- composition
    def composed_params(self, tenant: str, adapter: dict,
                        adapter_version: int, *, rank: int, alpha: float,
                        quantize: Optional[str] = None
                        ) -> "quant.ServingTree":
        """The tenant's serving tree: the shared (possibly int8) base
        with this adapter version composed in, cached per (tenant,
        adapter version) and rebuilt when the base's params version or
        the quantize mode changes."""
        slot, key = (tenant, int(adapter_version)), (
            self.base_net.params_version, quantize)
        with self._compose_lock:
            ent = self._composed_cache.get(slot)
            if ent is not None and ent["key"] == key:
                return ent["tree"]
            base_tree = quant.serving_params(self.base_net, quantize)
            tree = lora.compose_serving_tree(self.base_net, base_tree,
                                             adapter, rank=rank, alpha=alpha)
            self._composed_cache[slot] = {"key": key, "tree": tree}
            return tree

    def shared_base_copies(self) -> int:
        """Distinct base-weight copies across every deployed tenant: 1
        when every adapted leaf's base is a tensor of the base net's one
        serving tree (compared by `data_ptr()`), else 1 + the number of
        stray copies found."""
        base_tree = quant.serving_params(self.base_net, self.quantize)
        base = {_ptr(w) for lv in base_tree.params.values()
                for w in lv.values()}
        stray = set()
        for tenant in self.names():
            server, _ = self.active(tenant)
            tree = quant.serving_params(server.engine.net, None)
            for lv in tree.params.values():
                for w in lv.values():
                    if isinstance(w, lora.LoRAWeight) \
                            and _ptr(w.base) not in base:
                        stray.add(_ptr(w.base))
        return 1 + len(stray)

    # ----------------------------------------------------------- versions
    def _release_version(self, tenant: str, version: int):
        with self._compose_lock:
            self._composed_cache.pop((tenant, int(version)), None)
        self.registry.unpin_adapter(self.model, tenant, version)

    def _build_server(self, tenant: str, version, server_kw: dict,
                      warm_len, warm_tokens: int):
        """Resolve, compose, warm and start one tenant server. The target
        ADAPTER version is pinned before resolve (the FleetServer rule
        applied to the adapter store); pins taken here are released on
        failure."""
        reg = self.registry
        model = self.model
        target = (reg.latest_adapter(model, tenant)
                  if version == "latest" else int(version))
        if target is None:
            raise FileNotFoundError(
                f"no published adapters for {model!r} tenant {tenant!r}")
        pinned_here = []

        def pin(v):
            reg.pin_adapter(model, tenant, v)
            pinned_here.append(v)

        pin(target)
        try:
            adapter, meta, v = reg.resolve_adapter(model, tenant, version)
            if v != target:
                pin(v)
                reg.unpin_adapter(model, tenant, target)
                pinned_here.remove(target)
            server_kw = dict(server_kw)
            server_kw.setdefault("name", tenant)
            # quantization is the fleet's: the base quantizes once and
            # is shared, so the engine reads the composed tree and must
            # not quantize per tenant
            qmode = server_kw.pop("quantize", self.quantize)
            rank, alpha = int(meta["rank"]), float(meta["alpha"])
            # the factors go to the device once, at the first compose
            self.composed_params(tenant, adapter, v, rank=rank,
                                 alpha=alpha, quantize=qmode)

            def tree_of(_mode):
                return self.composed_params(tenant, adapter, v, rank=rank,
                                            alpha=alpha, quantize=qmode)

            view = _TenantNetView(self.base_net, tree_of)
            server = GenerationServer(view, device=self.device, **server_kw)
            with self._lock:
                prefixes = list(self._prefixes.get(tenant, ()))
            for ids in prefixes:
                server.register_prefix(ids)
            if warm_len is not None:
                server.warmup(warm_len, warm_tokens)
            server.start()
            return server, v
        except Exception:
            for v_ in pinned_here:
                reg.unpin_adapter(model, tenant, v_)
            raise

    # ----------------------------------------------------------- teardown
    def stop(self, *, drain: bool = False, drain_timeout: float = 600.0):
        try:
            super().stop(drain=drain, drain_timeout=drain_timeout)
        finally:
            self.registry.unpin(self.model, self.base_version)
