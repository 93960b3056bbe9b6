"""Per-layer training statistics computed inside the train step, the
non-finite watchdog, and the feed behind the stats listeners
(counterpart of `deeplearning4j_tpu/monitor/diagnostics.py`).

What a step computes, with diagnostics on (`Diagnostics.collect`), from
the tensors the step already has, on the device that runs it:

- per param leaf ("<layer>_<param>"): the mean |.| and the L2 norm of
  the gradient the updater consumed (after gradient normalization), of
  the applied update ``p_old - p_new`` and of the new param, and the
  ratio of the update's mean |.| to the param's;
- per layer, with `activation_stats`: the mean, the population std and
  the exactly-zero fraction of the layer's output in the forward,
  `[mean, std, dead]` in fp32 whatever the activation dtype;
- the finite flags: per layer, whether its gradients and updates hold
  no non-finite element, plus the loss (``finite.<loss>``) and the step
  (``nonfinite``). An element is counted, never a norm: a norm of
  finite values that overflows is not a non-finite element;
- optional fixed-bin histograms of each param (`torch.histc`).

The statistics are read from the step's tensors and never written back,
so params and the updater state stay bit-equal to a diagnostics-off run
unless the ``skip`` watchdog fires. They are packed into one fp32
vector on the device (one `torch.cat`), and `Diagnostics.read` copies
it to the host with ONE `.cpu()` (counted on
``jax_transfers_total{direction="d2h"}``); a `steps_per_execution`
group stacks its steps' vectors and reads them in one copy. Off the
report cadence nothing is read.

The per-leaf reductions are multi-tensor: `torch._foreach_norm` with
ord 1 and 2 over every leaf at once (the mean |.| is the L1 norm over
the element count), and the finite test is the L1 norm of ``x * 0``,
which is 0 for finite elements and NaN as soon as one is not.

Watchdog policies (``warn | skip | halt``): ``warn`` logs and counts;
``skip`` discards the bad update on the device: the containers snapshot
every param, the updater state tensors and the running state before the
update, and `collect_and_gate` puts the old values back with
``torch.where(ok, new, old)`` on the step's device-side ``ok`` (no host
sync; when the step is finite the select returns the new values bit for
bit); ``halt`` raises `NonFiniteGradientsError` naming the layers,
after recording the event in the flight recorder. The host actions run
at report cadence.

Resolution, as in the JAX package: the ``DL4J_DIAGNOSTICS`` environment
variable wins (``0/off`` forces off, ``1/on`` the defaults,
``warn|skip|halt`` the defaults with that policy), then the container's
``diagnostics=`` argument, then the configuration's ``diagnostics``
field, then off.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

log = logging.getLogger("deeplearning4j_tpu_torch")

_ENV_VAR = "DL4J_DIAGNOSTICS"

WATCHDOG_POLICIES = ("warn", "skip", "halt")

# per-(layer, param) statistics in the packed vector
PARAM_STATS = ("grad_mm", "grad_l2", "upd_mm", "upd_l2",
               "param_mm", "param_l2", "ratio")
# per-layer activation statistics
ACT_STATS = ("act_mean", "act_std", "act_dead")


class NonFiniteGradientsError(RuntimeError):
    """Raised by the ``halt`` watchdog policy: the step produced
    non-finite gradients/updates. Carries the offending layer keys and
    the iteration."""

    def __init__(self, layer_keys, iteration):
        self.layer_keys = sorted(str(k) for k in layer_keys)
        self.iteration = int(iteration)
        super().__init__(
            f"non-finite gradients/updates at iteration {iteration} "
            f"(layers {self.layer_keys}) — watchdog policy 'halt'")


@dataclasses.dataclass(frozen=True)
class DiagnosticsConfig:
    """Knobs of the in-step diagnostics (the JAX class's fields).

    activation_stats: per-layer activation mean/std/dead-unit fraction.
    histograms: fixed-bin parameter histograms (``histogram_bins`` bins
        over ``[-histogram_range, histogram_range]``).
    watchdog: None | "warn" | "skip" | "halt".
    report_frequency: host readback cadence in iterations; the step
        always computes (and ``skip`` always gates), only the readback
        follows the cadence.
    """

    activation_stats: bool = True
    histograms: bool = False
    histogram_bins: int = 20
    histogram_range: float = 1.0
    watchdog: Optional[str] = None
    report_frequency: int = 1

    def __post_init__(self):
        if self.watchdog is not None and self.watchdog not in WATCHDOG_POLICIES:
            raise ValueError(
                f"watchdog must be one of {WATCHDOG_POLICIES} (or None); "
                f"got {self.watchdog!r}")
        if self.report_frequency < 1:
            raise ValueError(
                f"report_frequency must be >= 1, got {self.report_frequency}")
        if self.histogram_bins < 2:
            raise ValueError(
                f"histogram_bins must be >= 2, got {self.histogram_bins}")
        if not self.histogram_range > 0:
            raise ValueError(
                f"histogram_range must be > 0, got {self.histogram_range}")

    def to_dict(self) -> dict:
        return {
            "activation_stats": self.activation_stats,
            "histograms": self.histograms,
            "histogram_bins": self.histogram_bins,
            "histogram_range": self.histogram_range,
            "watchdog": self.watchdog,
            "report_frequency": self.report_frequency,
        }

    @staticmethod
    def from_dict(d: dict) -> "DiagnosticsConfig":
        return DiagnosticsConfig(
            activation_stats=bool(d.get("activation_stats", True)),
            histograms=bool(d.get("histograms", False)),
            histogram_bins=int(d.get("histogram_bins", 20)),
            histogram_range=float(d.get("histogram_range", 1.0)),
            watchdog=d.get("watchdog"),
            report_frequency=int(d.get("report_frequency", 1)),
        )


def as_diagnostics(spec) -> Optional[DiagnosticsConfig]:
    """A user-facing spec as a DiagnosticsConfig (or None): None/False
    off, True/"on"/"default" the defaults, a watchdog policy name the
    defaults with that policy, a dict the serde form, a config itself."""
    if spec is None or spec is False:
        return None
    if spec is True:
        return DiagnosticsConfig()
    if isinstance(spec, DiagnosticsConfig):
        return spec
    if isinstance(spec, str):
        v = spec.strip().lower()
        if v in ("1", "on", "true", "yes", "default"):
            return DiagnosticsConfig()
        if v in ("0", "off", "false", "no"):
            return None
        if v in WATCHDOG_POLICIES:
            return DiagnosticsConfig(watchdog=v)
        raise ValueError(
            f"cannot interpret {spec!r} as a diagnostics spec; known "
            f"names: on/off/default or a watchdog policy "
            f"{WATCHDOG_POLICIES}")
    if isinstance(spec, dict):
        return DiagnosticsConfig.from_dict(spec)
    raise TypeError(f"cannot interpret {spec!r} as a diagnostics spec")


_ENV_OFF = object()  # sentinel: the environment forces diagnostics off


def env_diagnostics():
    """The ``DL4J_DIAGNOSTICS`` override: None when unset, `_ENV_OFF`
    when it forces diagnostics off, else a DiagnosticsConfig. Unknown
    spellings raise."""
    env = os.environ.get(_ENV_VAR)
    if env is None or not env.strip():
        return None
    v = env.strip().lower()
    if v in ("0", "off", "false", "no"):
        return _ENV_OFF
    if v in ("1", "on", "true", "yes"):
        return DiagnosticsConfig()
    if v in WATCHDOG_POLICIES:
        return DiagnosticsConfig(watchdog=v)
    raise ValueError(
        f"{_ENV_VAR}={env!r}: expected 0/off/1/on or a watchdog policy "
        f"{WATCHDOG_POLICIES}")


def resolve_diagnostics(explicit=None, conf=None) -> Optional[DiagnosticsConfig]:
    """The container's config: the environment (force-off included), then
    the explicit argument, then the configuration's field, then off."""
    forced = env_diagnostics()
    if forced is _ENV_OFF:
        return None
    if forced is not None:
        return forced
    e = as_diagnostics(explicit)
    if e is not None:
        return e
    return as_diagnostics(getattr(conf, "diagnostics", None))


# ------------------------------------------------------- in-step helpers
@torch.no_grad()
def activation_stats(h: torch.Tensor) -> torch.Tensor:
    """[mean, std, dead-fraction] of one layer's output in fp32 (the
    population std; statistics never accumulate in bf16)."""
    h = h.detach()
    std, mean = torch.std_mean(h.float(), correction=0)
    n = h.numel()
    dead = (n - torch.count_nonzero(h)).float() / n
    return torch.stack([mean, std, dead])


def snapshot(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Copies of `tensors` in one multi-tensor launch: ``x * 1`` is x bit
    for bit (-0.0 and NaN included)."""
    return list(torch._foreach_mul(tensors, 1.0)) if tensors else []


@torch.no_grad()
def keep_finite_(ok: torch.Tensor, new: List[torch.Tensor],
                 old: List[torch.Tensor]):
    """The ``skip`` gate in place: each of `new` becomes
    ``where(ok, new, old)`` on the device (the new values bit for bit
    when the step was finite)."""
    for n, o in zip(new, old):
        torch.where(ok, n, o.to(n.dtype), out=n)


def _stacked(ts) -> torch.Tensor:
    return torch.stack(list(ts))


class Diagnostics:
    """Per-model diagnostics: the in-step stat packing and the host-side
    readback and watchdog, sharing one DiagnosticsConfig. The layout (the
    key list describing the packed vector) is kept per step family
    (``name``; the containers' fit step is "fit") and set by `collect`."""

    def __init__(self, config: DiagnosticsConfig):
        self.config = config
        self.layouts: Dict[str, List[Tuple[str, int]]] = {}
        self.nonfinite_total = 0
        self.skipped_total = 0
        self.last: Optional[dict] = None
        self._const_key = None
        self._const = None

    def _constants(self, names, keys, layers, P, dev):
        """Each leaf's element count and layer index as device tensors,
        made once per layout: a fresh host->device copy each step would
        wait for the card."""
        ck = (tuple(names), str(dev))
        if self._const_key != ck:
            self._const = (
                torch.tensor([float(p.numel()) for p in P], device=dev),
                torch.tensor([layers.index(lk) for lk, _ in keys],
                             device=dev))
            self._const_key = ck
        return self._const

    @torch.no_grad()
    def collect(self, name: str, *, params_new, params_old, loss,
                grads=None, acts=None, extra_finite=None, xp=None):
        """The packed stat vector of ONE step, on the step's device.

        params_new, params_old: {layer key: {param name: tensor}} after
        and before the update (the old ones a snapshot). grads: the same
        keys, the gradients the updater consumed (any float dtype), or
        None. acts: {layer key: [3] activation stats}. loss: the step's
        loss tensor. extra_finite: more trees of the same keys (the
        exchanges' error-feedback residuals, one a replica) whose
        non-finite values count against their layers' finite flags.
        xp: a `parallel.collectives.CrossProcess` that sums the
        non-finite counts across processes (JAX's psum over the data
        axis), so every process gates the same way.

        Returns (vector, ok): ok is the step-global is-finite flag, a
        0-d bool tensor on the device (the ``skip`` gate's input)."""
        cfg = self.config
        keys = [(lk, pn) for lk in params_new for pn in params_new[lk]]
        layers = list(dict.fromkeys(lk for lk, _ in keys))
        names = [f"{lk}_{pn}" for lk, pn in keys]
        P = [params_new[lk][pn] for lk, pn in keys]
        O = [params_old[lk][pn] for lk, pn in keys]
        dev = P[0].device
        f32 = torch.float32
        count, layer_of = self._constants(names, keys, layers, P, dev)
        U = torch._foreach_sub([o.float() for o in O], [p.float() for p in P])
        stats = {}
        if grads is not None:
            G = [grads[lk][pn] for lk, pn in keys]
            stats["grad_mm"] = _stacked(torch._foreach_norm(
                G, 1, dtype=f32)) / count
            stats["grad_l2"] = _stacked(torch._foreach_norm(G, 2, dtype=f32))
        stats["upd_mm"] = _stacked(torch._foreach_norm(U, 1)) / count
        stats["upd_l2"] = _stacked(torch._foreach_norm(U, 2))
        stats["param_mm"] = _stacked(torch._foreach_norm(
            P, 1, dtype=f32)) / count
        stats["param_l2"] = _stacked(torch._foreach_norm(P, 2, dtype=f32))
        stats["ratio"] = stats["upd_mm"] / (stats["param_mm"] + 1e-12)
        # finite flags watch the UPDATE as well as the gradient: an inf
        # learning rate turns finite gradients into a non-finite update
        probe = _stacked(torch._foreach_norm(torch._foreach_mul(U, 0.0), 1))
        if grads is not None:
            probe = probe + _stacked(torch._foreach_norm(
                torch._foreach_mul(G, 0.0), 1, dtype=f32))
        leaf_bad = torch.isnan(probe).float()
        for tree in extra_finite or ():
            E = [tree[lk][pn] for lk, pn in keys]
            leaf_bad = leaf_bad + torch.isnan(_stacked(torch._foreach_norm(
                torch._foreach_mul(E, 0.0), 1, dtype=f32))).float()
        layer_bad = torch.zeros(len(layers), device=dev).index_add_(
            0, layer_of, leaf_bad)
        loss_bad = (~torch.isfinite(torch.as_tensor(loss, device=dev)
                                    .float())).float().sum()
        if xp is not None:
            both = torch.cat([layer_bad, loss_bad.reshape(1)])
            xp.all_reduce_([both])
            layer_bad, loss_bad = both[:-1], both[-1]
        total_bad = layer_bad.sum() + loss_bad

        layout: List[Tuple[str, int]] = []
        pieces = []
        for st in PARAM_STATS:
            if st in stats:
                layout += [(f"{st}.{n}", 1) for n in names]
                pieces.append(stats[st])
        if acts:
            A = torch.stack([acts[lk].float() for lk in acts])    # [nA, 3]
            for si, st in enumerate(ACT_STATS):
                layout += [(f"{st}.{lk}", 1) for lk in acts]
                pieces.append(A[:, si])
        layout += [(f"finite.{lk}", 1) for lk in layers]
        pieces.append((layer_bad == 0).float())
        layout += [("finite.<loss>", 1), ("nonfinite", 1)]
        pieces.append(torch.stack([(loss_bad == 0).float(),
                                   (total_bad > 0).float()]))
        if cfg.histograms:
            r = float(cfg.histogram_range)
            for n, p in zip(names, P):
                layout.append((f"hist.{n}", cfg.histogram_bins))
                pieces.append(torch.histc(p.detach().float().reshape(-1),
                                          bins=cfg.histogram_bins, min=-r,
                                          max=r))
        self.layouts[name] = layout
        return torch.cat(pieces), total_bad == 0

    # --------------------------------------------------------- host side
    def due(self, iteration: int) -> bool:
        return iteration % self.config.report_frequency == 0

    def read(self, dv: torch.Tensor, name: str) -> List[dict]:
        """ONE device->host copy of the packed vector (or a group's
        [k, K] stack), sliced by the layout into one structured dict per
        step."""
        from deeplearning4j_tpu_torch import monitor
        vec = dv.detach().cpu().numpy()
        monitor.record_transfer(vec.nbytes, "d2h")
        rows = vec if vec.ndim == 2 else vec[None]
        layout = self.layouts[name]
        out = []
        for row in rows:
            flat, off = {}, 0
            for k, size in layout:
                flat[k] = (float(row[off]) if size == 1
                           else np.array(row[off:off + size]))
                off += size
            out.append(self._structure(flat))
        return out

    @staticmethod
    def _structure(flat: dict) -> dict:
        d = {"params": {}, "activations": {}, "hists": {}, "finite": {},
             "nonfinite": bool(flat.get("nonfinite", 0.0))}
        for k, v in flat.items():
            if "." not in k:
                continue
            st, key = k.split(".", 1)
            if st in PARAM_STATS:
                d["params"].setdefault(key, {})[st] = v
            elif st in ACT_STATS:
                short = {"act_mean": "mean", "act_std": "std",
                         "act_dead": "dead"}[st]
                d["activations"].setdefault(key, {})[short] = v
            elif st == "hist":
                d["hists"][key] = v
            elif st == "finite":
                d["finite"][key] = bool(v)
        return d

    def process(self, model, dv, name: str, it0: int) -> List[dict]:
        """Read one step's (or one group's) vector, apply the watchdog's
        host actions, publish the registry gauges and keep the newest
        host stats on the model (``model._last_diagnostics``). Raises
        NonFiniteGradientsError under ``halt``."""
        if dv is None:
            return []
        rows = self.read(dv, name)
        policy = self.config.watchdog
        from deeplearning4j_tpu_torch import monitor
        mon = monitor.is_enabled()
        reg = monitor.registry() if mon else None
        for i, row in enumerate(rows):
            if not row["nonfinite"]:
                continue
            bad = [k for k, fine in row["finite"].items() if not fine]
            self.nonfinite_total += 1
            if mon:
                reg.counter(
                    "watchdog_nonfinite_total",
                    help="steps that produced non-finite grads/updates",
                ).inc()
                reg.gauge("watchdog_last_nonfinite_iteration",
                          help="iteration of the last non-finite step",
                          ).set(float(it0 + i))
            if policy == "skip":
                self.skipped_total += 1
                if mon:
                    reg.counter(
                        "watchdog_skipped_total",
                        help="updates discarded in-graph by the skip "
                             "policy").inc()
                log.warning(
                    "diagnostics watchdog: non-finite update at iteration "
                    "%d (layers %s) — update SKIPPED in-graph",
                    it0 + i, sorted(bad))
            elif policy == "halt":
                from deeplearning4j_tpu_torch.monitor.flightrec import (
                    GLOBAL_FLIGHT_RECORDER)
                GLOBAL_FLIGHT_RECORDER.record(
                    "watchdog_halt", layers=sorted(bad),
                    iteration=int(it0 + i))
                raise NonFiniteGradientsError(bad, it0 + i)
            elif policy == "warn":
                log.warning(
                    "diagnostics watchdog: non-finite gradients/"
                    "updates at iteration %d (layers %s)",
                    it0 + i, sorted(bad))
        last = rows[-1]
        if mon:
            for key, st in last["params"].items():
                if "grad_l2" in st:
                    reg.gauge("training_grad_l2",
                              help="per-param gradient L2 norm",
                              param=key).set(st["grad_l2"])
                reg.gauge("training_update_l2",
                          help="per-param applied-update L2 norm",
                          param=key).set(st["upd_l2"])
                reg.gauge("training_update_ratio",
                          help="mean |update| : mean |param| ratio",
                          param=key).set(st["ratio"])
            for lk, st in last["activations"].items():
                reg.gauge("training_activation_std",
                          help="per-layer activation std",
                          layer=lk).set(st["std"])
                reg.gauge("training_activation_dead",
                          help="per-layer exactly-zero activation "
                               "fraction", layer=lk).set(st["dead"])
        self.last = last
        model._last_diagnostics = last
        return rows


@torch.no_grad()
def collect_and_gate(diag, name: str, *, params, params_old, updates,
                     updates_old, state_new, state_old, grads, loss,
                     acts=None):
    """The containers' diagnostics tail, after the in-place update:
    collect the step's stats and, under ``skip``, put the old values
    back where the step was not finite. `params`/`params_old` are trees
    ({layer: {param: tensor}}, the live params and their snapshot),
    `updates`/`updates_old` flat lists (the live updater-state tensors
    and their snapshot, empty unless ``skip``); `state_new` is the
    running state the forward computed and `state_old` the live buffers
    it is about to overwrite. Returns (vector, state to commit)."""
    dv, ok = diag.collect(name, params_new=params, params_old=params_old,
                          grads=grads, loss=loss, acts=acts)
    if diag.config.watchdog == "skip":
        keep_finite_(ok, [t for lp in params.values() for t in lp.values()],
                     [t for lp in params_old.values() for t in lp.values()])
        keep_finite_(ok, updates, updates_old)
        state_new = {k: {n: (torch.where(ok, t, state_old[k][n])
                             if n in state_old.get(k, {}) else t)
                         for n, t in st.items()}
                     for k, st in state_new.items()}
    return dv, state_new


def process_if_due(model, dv, name: str, it0: int, steps: int = 1):
    """Process the step's vector (or a group's list of vectors, stacked
    here) iff the model has diagnostics and any covered iteration is on
    cadence; the host rows, or None (nothing read, zero transfers)."""
    md = getattr(model, "_diag", None)
    if md is None or dv is None or (isinstance(dv, list) and dv[0] is None):
        return None
    if not any(md.due(it0 + j) for j in range(steps)):
        return None
    if isinstance(dv, list):
        dv = torch.stack(dv)
    return md.process(model, dv, name, it0)


# ----------------------------------------------- batched host readback
def _flatten(tree, path=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _flatten(tree[k], path + (k,))
    else:
        yield path, tree


def _unflatten(pairs):
    out: dict = {}
    for path, v in pairs:
        if not path:
            return v
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out


def batched_host_tree(tree):
    """Every leaf of a tree of tensors (nested dicts) as host numpy in ONE
    device->host copy: the leaves are raveled to fp32 and concatenated
    on the device, copied with one `.cpu()` (counted as one d2h
    transfer) and cut back into their shapes. A tree already on the host
    (numpy or CPU tensors) comes back as numpy with no transfer."""
    pairs = list(_flatten(tree))
    if not pairs:
        return tree
    leaves = [v for _, v in pairs]
    if all(isinstance(l, np.ndarray) or (isinstance(l, torch.Tensor)
                                         and l.device.type == "cpu")
           for l in leaves):
        return _unflatten((p, np.asarray(v.detach() if isinstance(
            v, torch.Tensor) else v)) for p, v in pairs)
    from deeplearning4j_tpu_torch import monitor
    flat = torch.cat([torch.as_tensor(l).detach().float().reshape(-1)
                      for l in leaves]).cpu().numpy()
    monitor.record_transfer(flat.nbytes, "d2h")
    out, off = [], 0
    for path, l in pairs:
        n = int(np.prod(tuple(l.shape)))
        out.append((path, flat[off:off + n].reshape(tuple(l.shape))))
        off += n
    return _unflatten(out)
