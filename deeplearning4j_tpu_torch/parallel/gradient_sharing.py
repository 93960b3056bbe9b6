"""Threshold-encoded gradient sharing: error-feedback compressed
exchanges (counterpart of `deeplearning4j_tpu/parallel/gradient_sharing.py`).

The numbers are JAX's. Per replica r and exchange bucket:

    acc_r      = u_r + residual_r              (u_r the replica's update)
    enc_r      = sign(acc_r) * (|acc_r| >= τ)  (int8 on the wire)
    residual_r = acc_r - τ * enc_r             (nothing is lost)
    û          = (Σ_r enc_r) * (τ * (1 / N))   (the shared update)

and τ steps geometrically toward the target band of the encoded
fraction (`adapt_threshold`). What "threshold" encodes is the replica's
post-updater UPDATE (each replica runs its own updater), so τ lives on
the learning-rate scale; "threshold_rs" encodes the raw gradient and
runs the updater on the decoded shard. "dense_rs" reduce-scatters the
gradient, runs the updater on each replica's shard with sharded
updater state, and all-gathers the updated params.

A bucket is one packed run of the container (`nn/container.py`
`_packed_runs`, the JAX ``stacked::`` entries) or one other layer with
params (`bucket_plan`). The residual, τ and the per-replica updater
state are keyed by LAYER; a run's members share the run's τ.

What this module holds: the mode and bucket switches with JAX's
environment variables (`resolve_mode`, `resolve_bucketed`), the
`ThresholdConfig`, the encoder and the τ controller, the τ trees, the
rs shard plan, and the host-side comm accounting with JAX's metric
names. The trainer (`parallel/trainer.py`) runs the replicas and
reduces across them through `parallel/collectives.py`. JAX's
`exchange_jaxpr` and its partial-manual scan probe are XLA analyses with
no PyTorch counterpart.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.parallel.collectives import reduce_sum

MODES = ("dense", "threshold", "dense_rs", "threshold_rs")
RS_MODES = ("dense_rs", "threshold_rs")

_ENV_VAR = "DL4J_GRADIENT_SHARING"
_ENV_DENSE = ("dense", "0", "off", "false", "no")
_ENV_THRESHOLD = ("threshold", "1", "on", "true", "yes")
_BUCKET_ENV_VAR = "DL4J_BUCKETED_EXCHANGE"
RUN_PREFIX = "stacked::"     # JAX's bucket key of a packed run


def resolve_bucketed(explicit: Optional[bool] = None) -> bool:
    """`DL4J_BUCKETED_EXCHANGE` (0/off/false/no, 1/on/true/yes; anything
    else raises) wins, then the trainer's argument, then True."""
    env = os.environ.get(_BUCKET_ENV_VAR)
    if env is not None and env.strip():
        v = env.strip().lower()
        if v in ("0", "off", "false", "no"):
            return False
        if v in ("1", "on", "true", "yes"):
            return True
        raise ValueError(
            f"{_BUCKET_ENV_VAR}={env!r}: expected one of "
            f"('0', 'off', 'false', 'no', '1', 'on', 'true', 'yes')")
    if explicit is not None:
        return bool(explicit)
    return True


@dataclasses.dataclass(frozen=True)
class ThresholdConfig:
    """The encoder's initial τ and the adaptive controller's band and
    steps (JAX's defaults and validation)."""

    initial_threshold: float = 1e-3
    sparsity_target_min: float = 1e-3
    sparsity_target_max: float = 1e-1
    decay: float = 1.0 / 1.2
    boost: float = 1.2
    min_threshold: float = 1e-8
    max_threshold: float = 1.0

    def __post_init__(self):
        if not (0.0 < self.sparsity_target_min
                <= self.sparsity_target_max <= 1.0):
            raise ValueError(
                f"sparsity target band must satisfy 0 < min <= max <= 1, "
                f"got [{self.sparsity_target_min}, "
                f"{self.sparsity_target_max}]")
        if not (0.0 < self.decay < 1.0 < self.boost):
            raise ValueError(
                f"need decay < 1 < boost, got decay={self.decay} "
                f"boost={self.boost}")
        if not (0.0 < self.min_threshold <= self.initial_threshold
                <= self.max_threshold):
            raise ValueError(
                f"need min_threshold <= initial_threshold <= "
                f"max_threshold, got {self.min_threshold} / "
                f"{self.initial_threshold} / {self.max_threshold}")

    @staticmethod
    def from_conf(conf) -> "ThresholdConfig":
        """The configuration's `gradient_sharing_threshold` as the
        initial τ, the controller's defaults for the rest."""
        tau0 = getattr(conf, "gradient_sharing_threshold", None)
        if tau0 is None:
            return ThresholdConfig()
        return ThresholdConfig(initial_threshold=float(tau0))


def env_mode() -> Optional[str]:
    """The `DL4J_GRADIENT_SHARING` override (validated), or None."""
    env = os.environ.get(_ENV_VAR)
    if env is None or not env.strip():
        return None
    v = env.strip().lower()
    if v in _ENV_DENSE:
        return "dense"
    if v in _ENV_THRESHOLD:
        return "threshold"
    if v in RS_MODES:
        return v
    raise ValueError(
        f"{_ENV_VAR}={env!r}: expected one of "
        f"{_ENV_DENSE + _ENV_THRESHOLD + RS_MODES}")


def resolve_mode(explicit: Optional[str] = None, conf=None) -> str:
    """`DL4J_GRADIENT_SHARING` > the trainer's argument > the
    configuration's `gradient_sharing` > "dense"."""
    forced = env_mode()
    if forced is not None:
        return forced
    for v in (explicit, getattr(conf, "gradient_sharing", None)):
        if v is not None:
            if v not in MODES:
                raise ValueError(
                    f"gradient_sharing must be one of {MODES}, got {v!r}")
            return v
    return "dense"


def wire_dtype(n_workers: int) -> torch.dtype:
    """The narrowest integer whose sum of n_workers signs is exact: int8
    up to 127 replicas, int16 beyond."""
    if n_workers <= 127:
        return torch.int8
    if n_workers <= 32767:
        return torch.int16
    raise ValueError(
        f"threshold gradient sharing supports data axes up to 32767 "
        f"replicas, got {n_workers}")


# ------------------------------------------------------------ encode/decode
def encode_leaf(acc: torch.Tensor, tau, wdtype
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One leaf of the encoder: (wire tensor, residual, elements sent as
    a float32 count). `acc` is the update (or gradient) plus the carried
    residual; `tau` a float32 scalar tensor."""
    t = torch.as_tensor(tau, device=acc.device).to(acc.dtype)
    mask = acc.abs() >= t
    enc = torch.where(mask, torch.sign(acc),
                      torch.zeros((), dtype=acc.dtype,
                                  device=acc.device)).to(wdtype)
    residual = acc - enc.to(acc.dtype) * t
    return enc, residual, mask.sum(dtype=torch.float32)


def decode_scale(tau: torch.Tensor, n_workers: int, dtype) -> torch.Tensor:
    """τ · (1/N) in `dtype` (JAX's `tau.astype(g.dtype) *
    g.dtype.type(1/N)`): the factor that turns the integer sum into the
    shared mean update."""
    return tau.to(dtype) * float(np.float32(1.0 / float(n_workers)))


def adapt_threshold(tau: torch.Tensor, sparsity: torch.Tensor,
                    cfg: ThresholdConfig) -> torch.Tensor:
    """One controller step: boost τ above the target band, decay it
    below, clamp always (float32)."""
    tau = torch.where(sparsity > cfg.sparsity_target_max, tau * cfg.boost,
                      torch.where(sparsity < cfg.sparsity_target_min,
                                  tau * cfg.decay, tau))
    return torch.clamp(tau, cfg.min_threshold, cfg.max_threshold)


def tree_elements(tree) -> float:
    """Element count of a nested dict of tensors or arrays."""
    if isinstance(tree, dict):
        return float(sum(tree_elements(v) for v in tree.values()))
    return float(int(np.prod(tuple(tree.shape))))


def zeros_residual(params, device=None):
    """A zero residual tree shaped like `params` ({layer: {name:
    tensor}}), on `device` (the params' own when None)."""
    if isinstance(params, dict):
        return {k: zeros_residual(v, device) for k, v in params.items()}
    return torch.zeros(tuple(params.shape), dtype=params.dtype,
                       device=device if device is not None
                       else params.device)


def elementwise_gn(g: torch.Tensor, gn, gn_t) -> torch.Tensor:
    """The gradient normalization the rs modes run on reduced shards:
    elementwise clipping, or nothing."""
    gn = getattr(gn, "value", gn) or "none"
    if gn == "clip_elementwise_absolute_value":
        return torch.clamp(g, -gn_t, gn_t)
    return g


def rs_supported_gn(conf) -> bool:
    """True when the configuration's gradient normalization factorizes
    per element (the rs modes normalize reduced gradient shards)."""
    gn = getattr(conf, "gradient_normalization", None)
    gn = getattr(gn, "value", gn) or "none"
    return gn in ("none", "clip_elementwise_absolute_value")


def rs_shard_plan(params, n_workers: int, *, specs=None,
                  data_axis: str = "data",
                  min_shard_elems: int = 1024) -> dict:
    """{layer: {param: bool}}: which leaves the rs modes shard on their
    LAST axis. With `specs` ({layer: {param: tuple of axis names}}, the
    JAX PartitionSpec entries) a leaf shards iff its last entry names
    `data_axis`; without, iff its last axis divides by n_workers and it
    holds at least `min_shard_elems` elements (JAX's rule)."""
    plan = {}
    for lk, lparams in params.items():
        lplan = {}
        for pn, arr in lparams.items():
            if specs is not None:
                dims = tuple(specs[lk][pn])
                lplan[pn] = bool(dims and dims[-1] == data_axis)
            else:
                shape = tuple(arr.shape)
                lplan[pn] = bool(
                    shape and shape[-1] % n_workers == 0
                    and int(np.prod(shape)) >= min_shard_elems)
        plan[lk] = lplan
    return plan


# ---------------------------------------------------------------- τ trees
def init_tau_tree(params, cfg: ThresholdConfig) -> dict:
    """A fresh per-layer τ tree (np.float32 values)."""
    return {lk: np.float32(cfg.initial_threshold) for lk in params}


def coerce_tau(tau, layer_keys, cfg: Optional[ThresholdConfig] = None):
    """Checkpoint-form τ -> a per-layer tree: one scalar broadcasts, a
    tree keeps its keys (a missing key, or a missing τ, takes the
    configuration's initial value)."""
    keys = list(layer_keys)
    cfg = cfg or ThresholdConfig()
    if tau is None:
        return {lk: np.float32(cfg.initial_threshold) for lk in keys}
    if isinstance(tau, dict):
        return {lk: np.float32(_f32(tau[lk])) if lk in tau
                else np.float32(cfg.initial_threshold) for lk in keys}
    return {lk: np.float32(_f32(tau)) for lk in keys}


def _f32(v) -> np.float32:
    if isinstance(v, torch.Tensor):
        v = v.detach().to("cpu").numpy()
    return np.float32(np.asarray(v))


def ensure_tau_form(tau, per_bucket: bool, params, cfg: ThresholdConfig):
    """τ state in the form the step needs: a per-layer tree when
    `per_bucket`, one scalar otherwise (a scalar broadcasts, a tree
    collapses to its bucket mean; None starts fresh)."""
    if tau is None:
        return (init_tau_tree(params, cfg) if per_bucket
                else np.float32(cfg.initial_threshold))
    if per_bucket and not isinstance(tau, dict):
        return coerce_tau(tau, params.keys(), cfg)
    if not per_bucket and isinstance(tau, dict):
        return np.float32(tau_scalar(tau))
    return tau


def restore_tau(tau):
    """Checkpoint-form τ as written: a per-layer tree or one scalar."""
    if isinstance(tau, dict):
        return {lk: _f32(v) for lk, v in tau.items()}
    return _f32(tau)


def tau_scalar(tau) -> float:
    """The mean over buckets of a τ tree (the scalar of a scalar), in
    float32 as JAX's `np.asarray(stack).mean()`."""
    if isinstance(tau, dict):
        if not tau:
            return 0.0
        vals = np.asarray([_f32(v) for v in tau.values()], np.float32)
        return float(vals.mean())
    return float(_f32(tau))


# ------------------------------------------------------------ bucket plan
def run_key(keys) -> str:
    return RUN_PREFIX + ",".join(keys)


def bucket_plan(model) -> List[Tuple[str, List[str]]]:
    """Ordered (bucket key, [member layer keys]) of the model's exchange
    buckets in FORWARD order: its packed runs (``stacked::a,b,...``, JAX's
    keys) and every other layer with params."""
    runs = [[model.layer_keys[i] for i in r] for r in model._packed_runs()]
    members = {k for keys in runs for k in keys}
    entries = [(run_key(keys), list(keys)) for keys in runs]
    for lk, layer in model.keyed():
        if layer.jax_param_map() and lk not in members:
            entries.append((lk, [lk]))
    if hasattr(model.conf, "topo_order") and model.conf.topo_order:
        order = {name: i for i, name in enumerate(model.conf.topo_order)}
    else:
        order = {k: i for i, k in enumerate(model.layer_keys)}
    entries.sort(key=lambda e: min(order.get(m, 0) for m in e[1]))
    return entries


# ------------------------------------------------------ comm-bytes accounting
def _itemsize(dt) -> int:
    if isinstance(dt, torch.dtype):
        return torch.empty((), dtype=dt).element_size()
    if isinstance(dt, str) and dt in ("bfloat16", "bf16"):
        return 2
    return np.dtype(dt).itemsize


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _leaf_item(leaf) -> int:
    dt = getattr(leaf, "dtype", None)
    return _itemsize(dt if dt is not None else np.asarray(leaf).dtype)


def _is_float(leaf) -> bool:
    dt = getattr(leaf, "dtype", None)
    if isinstance(dt, torch.dtype):
        return dt.is_floating_point
    return np.issubdtype(np.dtype(dt if dt is not None
                                  else np.asarray(leaf).dtype), np.floating)


def exchange_wire_bytes(params, mode: str, *, n_workers: int = 2,
                        rs_plan: Optional[dict] = None,
                        grad_dtype=None) -> float:
    """One step's exchange payload per replica in bytes (host math on
    shapes, JAX's accounting): dense moves the gradients in their dtype
    (`grad_dtype` for floating leaves: bf16 under mixed_bf16);
    threshold the integer wire tensors plus two float32 scalars; the rs
    modes the gradient (or wire) reduce-scatter operand plus each
    sharded leaf's updated-param all-gather shard in the param dtype."""
    def grad_item(leaf):
        if grad_dtype is not None and _is_float(leaf):
            return _itemsize(grad_dtype)
        return _leaf_item(leaf)

    def elems(leaf):
        return int(np.prod(tuple(np.shape(leaf))))

    if mode == "dense":
        return float(sum(elems(l) * grad_item(l) for l in _leaves(params)))
    if mode in RS_MODES:
        if rs_plan is None:
            rs_plan = rs_shard_plan(params, n_workers)
        wire_item = (_itemsize(wire_dtype(n_workers))
                     if mode == "threshold_rs" else None)
        total = 8.0 if mode == "threshold_rs" else 0.0
        for lk, lparams in params.items():
            for pn, arr in lparams.items():
                e = float(elems(arr))
                total += e * (wire_item if wire_item is not None
                              else grad_item(arr))
                if rs_plan[lk][pn]:
                    total += (e / n_workers) * _leaf_item(arr)
        return total
    return tree_elements(params) * _itemsize(wire_dtype(n_workers)) + 8.0


def record_exchange(mode: str, wire_bytes: float, dense_bytes: float,
                    steps: int = 1, *, trainer: str = "parallel"):
    """The exchange counters and the compression-ratio gauge (host
    floats; nothing while monitoring is off)."""
    from deeplearning4j_tpu_torch import monitor
    if not monitor.is_enabled():
        return
    reg = monitor.registry()
    reg.counter("gradient_exchange_bytes_total",
                help="gradient all-reduce payload bytes per replica",
                mode=mode, trainer=trainer).inc(wire_bytes * steps)
    reg.counter("gradient_exchange_steps_total",
                help="sync steps per gradient-sharing mode",
                mode=mode, trainer=trainer).inc(steps)
    if wire_bytes > 0:
        reg.gauge("gradient_sharing_compression_ratio",
                  help="dense/wire bytes of the gradient exchange",
                  trainer=trainer).set(dense_bytes / wire_bytes)


def record_threshold_stats(tau: float, sparsity: float, *,
                           trainer: str = "parallel"):
    """The controller's gauges, from values already on the host."""
    from deeplearning4j_tpu_torch import monitor
    if not monitor.is_enabled():
        return
    reg = monitor.registry()
    reg.gauge("gradient_sharing_threshold",
              help="current adaptive threshold tau",
              trainer=trainer).set(float(tau))
    reg.gauge("gradient_sharing_sparsity",
              help="achieved encoded fraction of the last exchange",
              trainer=trainer).set(float(sparsity))


def threshold_exchange(deltas: List[Dict[str, Dict[str, torch.Tensor]]],
                       residuals: List[Dict[str, Dict[str, torch.Tensor]]],
                       tau: torch.Tensor, cfg: ThresholdConfig, *,
                       device, xp=None, n_total: Optional[int] = None
                       ) -> tuple:
    """The whole compressed exchange of one bucket over the replicas:
    each replica encodes its update plus residual at τ, the integer
    wire tensors sum in replica order, the sum decodes to the shared
    update on `device`, and τ adapts from the mean encoded fraction.
    `deltas[r]`/`residuals[r]` are replica r's {layer: {param: tensor}}.
    Returns (shared update tree, new residuals, new τ, sparsity); the
    residual trees are updated in place and returned. Across processes
    `deltas` are this process's replicas, `n_total` all of them, and
    `xp` (`collectives.CrossProcess`) sums the wire tensors and the sent
    counts across the processes after this process's replica-order
    sum."""
    n = int(n_total or len(deltas))
    wdtype = wire_dtype(n)
    summed: Dict[str, Dict[str, torch.Tensor]] = {}
    sent_r = []
    for d, res in zip(deltas, residuals):
        sent = torch.zeros((), dtype=torch.float32, device=device)
        for lk, ld in d.items():
            for pk, u in ld.items():
                enc, new_res, s = encode_leaf(u + res[lk][pk].to(u.dtype),
                                              tau, wdtype)
                res[lk][pk] = new_res.to(res[lk][pk].dtype)
                slot = summed.setdefault(lk, {})
                e = enc.to(device, torch.int32)
                slot[pk] = e if pk not in slot else slot[pk].add_(e)
                sent = sent + s.to(device)
        sent_r.append(sent)
    like = deltas[0]
    sent = reduce_sum(sent_r, device)
    if xp is not None:
        xp.all_reduce_([t for ld in summed.values() for t in ld.values()]
                       + [sent])
    dhat = {lk: {pk: s.to(like[lk][pk].dtype)
                 * decode_scale(tau, n, like[lk][pk].dtype)
                 for pk, s in ld.items()} for lk, ld in summed.items()}
    sparsity = sent.div_(torch.tensor(n, dtype=sent.dtype, device=device)) \
        / torch.tensor(tree_elements(like), dtype=torch.float32,
                       device=device)
    return dhat, residuals, adapt_threshold(tau, sparsity, cfg), sparsity
