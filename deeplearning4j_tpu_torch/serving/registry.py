"""ModelRegistry: the fleet tier's versioned model store (counterpart
of `deeplearning4j_tpu/serving/registry.py`, its model half). The store
is a directory tree of ModelSerializer zips, the format both packages
read and write, so a root published by one package resolves in the
other:

    <root>/<name>/v<version>.zip

Contracts:

- **Publish is one-winner.** The zip is written at a hidden tmp path in
  the model's directory (ModelSerializer's own tmp + fsync + replace
  makes that write atomic), then claimed with `os.link(tmp, final)`,
  which fails with EEXIST when the version is taken: of concurrent
  publishes of one `(name, version)` exactly one wins, the others raise
  `VersionConflictError`; auto-versioned publishes retry at the next
  free number. A crash mid-publish leaves a whole zip or an ignored tmp
  orphan, never a torn version.
- **Resolve verifies before it trusts.** `resolve(name, "latest")` walks
  the versions newest-first; `ModelSerializer.restore_model` checks each
  zip's per-array crc32 set, and a corrupt newer version falls back to
  the one before with a logged warning (`registry_resolve_fallback_total`
  counts them). Only when every version fails does
  `CheckpointCorruptError` propagate, naming each candidate. An explicit
  version fails hard on corruption.
- **Retention never collects a pinned version.** Keep the newest
  `keep_last` versions plus every `keep_every`-th, delete the rest, but
  never a version pinned by this process or by a live process's on-disk
  `.pin-v<version>.<pid>` marker (the FleetServer pins what it serves).
- **Checkpoint-as-publish is a one-liner.**
  `registry.publish_listener(name, frequency=N)` returns a
  TrainingListener that publishes at step boundaries only, as
  `fault/listener.py`'s CheckpointListener checkpoints.

The adapter store (JAX `serving/registry.py:400-611`, and
`AdapterPublishListener` :793-835): per-tenant LoRA adapter deltas
(`tenancy/lora.py`), the multi-tenant fleet's publish unit, one level
down with a version sequence per tenant:

    <root>/<name>/adapters/<tenant>/v<version>.zip

under the same contracts (one-winner link claim, newest-first resolve
with corrupt-artifact fallback, retention that never collects a pinned
adapter, pins riding `.pin-v<v>.<pid>` markers in the tenant's
directory). The artifact is the adapter zip both packages read.
"""

from __future__ import annotations

import logging
import os
import threading
import uuid
from pathlib import Path
from typing import List, Optional, Set, Tuple, Union

from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.fault.errors import CheckpointCorruptError
from deeplearning4j_tpu_torch.monitor.flightrec import GLOBAL_FLIGHT_RECORDER
from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener
from deeplearning4j_tpu_torch.util.serializer import ModelSerializer

log = logging.getLogger("deeplearning4j_tpu_torch.serving.registry")


class VersionConflictError(RuntimeError):
    """An explicit `(name, version)` publish lost the one-winner race:
    that version already exists (another publisher claimed it first).
    Re-publish without `version=` to take the next free number."""


def _version_of(p: Path) -> Optional[int]:
    n = p.name
    if not (n.startswith("v") and n.endswith(".zip")):
        return None
    try:
        return int(n[1:-4])
    except ValueError:
        return None


class ModelRegistry:
    """Named+versioned model store over ModelSerializer zips.

    Thread-safe for concurrent publish/resolve from one process;
    cross-process safety comes from the filesystem claim protocol
    itself (link-based one-winner publish, atomic zip commits)."""

    def __init__(self, root: Union[str, Path], *, keep_last: int = 3,
                 keep_every: Optional[int] = None):
        if keep_last < 1:
            raise ValueError(f"keep_last must be >= 1, got {keep_last}")
        if keep_every is not None and keep_every < 1:
            raise ValueError(f"keep_every must be >= 1, got {keep_every}")
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self.keep_every = keep_every
        self._lock = threading.Lock()
        self._pinned: Set[Tuple[str, int]] = set()
        self._adapter_pinned: Set[Tuple[str, str, int]] = set()
        self._metrics_cache = None

    # ------------------------------------------------------------- layout
    def model_dir(self, name: str) -> Path:
        if not name or "/" in name or name.startswith("."):
            raise ValueError(f"invalid model name {name!r}")
        return self.root / name

    def path(self, name: str, version: int) -> Path:
        return self.model_dir(name) / f"v{int(version)}.zip"

    def models(self) -> List[str]:
        if not self.root.exists():
            return []
        return sorted(d.name for d in self.root.iterdir()
                      if d.is_dir() and not d.name.startswith(".")
                      and self.versions(d.name))

    def versions(self, name: str) -> List[int]:
        """Committed versions of `name`, ascending (tmp orphans and
        foreign files are ignored)."""
        d = self.model_dir(name)
        if not d.exists():
            return []
        out = [v for v in (_version_of(p) for p in d.iterdir())
               if v is not None]
        return sorted(out)

    def latest(self, name: str) -> Optional[int]:
        vs = self.versions(name)
        return vs[-1] if vs else None

    # ------------------------------------------------------------ metrics
    def _metrics(self):
        return monitor.resolve_cached_metrics(
            self, "_metrics_cache", lambda reg: {
                "published": lambda name: reg.counter(
                    "registry_published_total",
                    "model versions published", model=name),
                "models": reg.gauge(
                    "registry_models",
                    "distinct model names in the registry"),
                "versions": lambda name: reg.gauge(
                    "registry_versions",
                    "committed versions currently retained",
                    model=name),
                "gc": reg.counter("registry_gc_total",
                                  "versions deleted by retention GC"),
                "fallback": reg.counter(
                    "registry_resolve_fallback_total",
                    "corrupt-version fallbacks during resolve"),
            })

    def _publish_gauges(self, name: str, m):
        if m is None:
            return
        m["models"].set(len(self.models()))
        m["versions"](name).set(len(self.versions(name)))

    # ------------------------------------------------------------ publish
    def publish(self, name: str, net, *, version: Optional[int] = None,
                save_updater: bool = False, normalizer=None) -> int:
        """Publish `net` as a new version of `name`; returns the version
        committed. `version=None` takes the next free number (retrying
        past concurrent publishers); an explicit `version` that already
        exists raises `VersionConflictError` — exactly one of any set
        of concurrent same-version publishers wins.

        `save_updater=False` by default: a served release needs weights
        and normalizer state, not optimizer slots (pass True to keep
        the zip resumable as a training checkpoint too).

        `normalizer`: a fitted DataNormalization (e.g. a
        `WindowedStandardize.snapshot()`) baked INTO the zip before the
        claim — the release carries the input statistics it trained
        under (`ModelSerializer.restore_normalizer_from_file` reads it
        back)."""
        d = self.model_dir(name)
        d.mkdir(parents=True, exist_ok=True)
        tmp = d / f".publish-{os.getpid()}-{uuid.uuid4().hex[:8]}.tmp.zip"
        try:
            ModelSerializer.write_model(net, tmp, save_updater=save_updater)
            if normalizer is not None:
                ModelSerializer.add_normalizer_to_model(tmp, normalizer)
            if version is not None:
                committed = self._claim(tmp, self.path(name, int(version)),
                                        int(version))
                if committed is None:
                    raise VersionConflictError(
                        f"{name} v{version} already exists — a concurrent "
                        f"publish won the claim; publish without version= "
                        f"to take the next free number")
            else:
                while True:
                    nxt = (self.latest(name) or 0) + 1
                    committed = self._claim(tmp, self.path(name, nxt), nxt)
                    if committed is not None:
                        break
        finally:
            if tmp.exists():
                tmp.unlink()
        self._fsync_dir(d)
        m = self._metrics()
        if m is not None:
            m["published"](name).inc()
        self._gc(name, m)
        self._publish_gauges(name, m)
        GLOBAL_FLIGHT_RECORDER.record("publish", model=name,
                                      version=committed)
        log.info("published %s v%d -> %s", name, committed,
                 self.path(name, committed))
        return committed

    @staticmethod
    def _claim(tmp: Path, final: Path, version: int) -> Optional[int]:
        """Claim `version` by hard-linking the finished tmp zip to its
        final path: `os.link` is atomic and fails with EEXIST when the
        version is already taken — the one-winner primitive (models and
        adapters alike)."""
        try:
            os.link(tmp, final)
            return version
        except FileExistsError:
            return None

    @staticmethod
    def _fsync_dir(d: Path):
        try:
            fd = os.open(d, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        except OSError:  # platform without directory fsync
            pass

    # ------------------------------------------------------------ resolve
    def resolve(self, name: str, version: Union[int, str] = "latest", *,
                load_updater: bool = False, device="cuda"):
        """Load a model from the registry onto `device`; returns ``(net,
        version)``.

        `version="latest"` walks newest-first with corrupt-zip fallback
        (each failure logged + counted); an explicit integer version
        verifies that exact zip and raises `CheckpointCorruptError` on
        damage — no silent substitution under a pin. Asking for CUDA
        without a card raises before any zip is read."""
        device = resolve_device(device)
        vs = self.versions(name)
        if not vs:
            raise FileNotFoundError(
                f"no published versions of {name!r} under {self.root} "
                f"(known models: {self.models()})")
        if version != "latest":
            v = int(version)
            if v not in vs:
                raise FileNotFoundError(
                    f"{name} v{v} is not in the registry "
                    f"(have {vs})")
            net = ModelSerializer.restore_model(
                self.path(name, v), load_updater=load_updater,
                device=device)
            return net, v
        m = self._metrics()
        tried = []
        for v in reversed(vs):
            try:
                net = ModelSerializer.restore_model(
                    self.path(name, v), load_updater=load_updater,
                    device=device)
                return net, v
            except CheckpointCorruptError as e:
                log.warning(
                    "%s v%d is corrupt (%s); falling back to the "
                    "previous version", name, v, e)
                if m is not None:
                    m["fallback"].inc()
                tried.append((v, e))
        detail = "; ".join(f"v{v}: {e}" for v, e in tried)
        raise CheckpointCorruptError(
            f"every published version of {name!r} failed verification "
            f"({len(tried)} candidates tried) — {detail}")

    # ---------------------------------------------------------- retention
    @staticmethod
    def _pin_marker(d: Path, version: int) -> Path:
        """This process's pin marker of `version` in store directory `d`
        (a model's, or a tenant's adapter directory)."""
        return d / f".pin-v{int(version)}.{os.getpid()}"

    def _mark(self, d: Path, version: int):
        d.mkdir(parents=True, exist_ok=True)
        try:
            self._pin_marker(d, version).touch()
        except OSError:
            pass

    def _unmark(self, d: Path, version: int):
        try:
            self._pin_marker(d, version).unlink()
        except OSError:
            pass   # marker already gone (or never written)

    def pin(self, name: str, version: int):
        """Protect `(name, version)` from retention GC — the
        currently-served contract: a FleetServer pins every version an
        engine is decoding from, so GC can never delete live weights.

        Pins are ALSO recorded as on-disk markers
        (`.pin-v<version>.<pid>`): retention runs in whichever process
        publishes (e.g. a trainer with a publish listener over the
        same root a separate serving process reads), and an in-memory
        set would be invisible to it. GC honors markers whose pid is
        still alive and sweeps stale ones from dead processes."""
        with self._lock:
            self._pinned.add((name, int(version)))
        self._mark(self.model_dir(name), version)

    def unpin(self, name: str, version: int):
        with self._lock:
            self._pinned.discard((name, int(version)))
        self._unmark(self.model_dir(name), version)
        # a version that outlived its pin only because it was pinned
        # gets collected at the next publish; sweep now so undeploys
        # don't leave strays until then
        self._gc(name, self._metrics())

    def pinned(self) -> Set[Tuple[str, int]]:
        """THIS process's pins (the serving process's own view);
        cross-process protection rides the on-disk markers."""
        with self._lock:
            return set(self._pinned)

    @staticmethod
    def _pid_alive(pid: int) -> bool:
        try:
            os.kill(pid, 0)
            return True
        except ProcessLookupError:
            return False
        except OSError:   # e.g. EPERM: alive under another uid
            return True

    def _marker_pins(self, d: Path) -> Set[int]:
        """Versions in store directory `d` pinned by ANY live process
        (marker files); stale markers from dead pids are swept here."""
        import re
        keep: Set[int] = set()
        if not d.exists():
            return keep
        for p in d.glob(".pin-v*.*"):
            m = re.fullmatch(r"\.pin-v(\d+)\.(\d+)", p.name)
            if not m:
                continue
            v, pid = int(m.group(1)), int(m.group(2))
            if pid == os.getpid() or self._pid_alive(pid):
                keep.add(v)
            else:
                try:
                    p.unlink()
                except OSError:
                    pass
        return keep

    def _collect(self, d: Path, vs: List[int], pinned: Set[int],
                 path_of, label: str, m) -> None:
        """Retention over one store directory `d` holding versions `vs`:
        keep the newest `keep_last`, every `keep_every`-th, this
        process's `pinned` and every live process's markers; unlink the
        rest (`path_of(v)`)."""
        keep = set(vs[-self.keep_last:])
        if self.keep_every:
            keep.update(v for v in vs if v % self.keep_every == 0)
        keep.update(pinned)
        keep.update(self._marker_pins(d))
        dropped = 0
        for v in vs:
            if v in keep:
                continue
            try:
                path_of(v).unlink()
                dropped += 1
                log.info("retention GC dropped %s v%d", label, v)
            except OSError:
                pass
        if dropped and m is not None:
            m["gc"].inc(dropped)

    def _gc(self, name: str, m=None):
        with self._lock:
            pinned = {v for n, v in self._pinned if n == name}
        d = self.model_dir(name)
        self._collect(d, self.versions(name), pinned,
                      lambda v: self.path(name, v), name, m)
        # stale publish tmp orphans (a killed publisher's leftovers).
        # AGE-GATED: a fresh tmp is very likely a CONCURRENT publisher
        # mid-write — unlinking it between its write_model and its
        # link-claim would turn the loser's VersionConflictError into
        # a FileNotFoundError and break the one-winner contract
        import time as _time
        cutoff = _time.time() - 3600.0
        for p in d.glob(".publish-*.tmp.zip"):
            try:
                if p.stat().st_mtime < cutoff:
                    p.unlink()
            except OSError:
                pass

    # ----------------------------------------------------- adapter store
    def adapter_dir(self, name: str, tenant: str) -> Path:
        if not tenant or "/" in tenant or tenant.startswith("."):
            raise ValueError(f"invalid tenant name {tenant!r}")
        return self.model_dir(name) / "adapters" / tenant

    def adapter_path(self, name: str, tenant: str, version: int) -> Path:
        return self.adapter_dir(name, tenant) / f"v{int(version)}.zip"

    def tenants(self, name: str) -> List[str]:
        d = self.model_dir(name) / "adapters"
        if not d.exists():
            return []
        return sorted(t.name for t in d.iterdir()
                      if t.is_dir() and not t.name.startswith(".")
                      and self.adapter_versions(name, t.name))

    def adapter_versions(self, name: str, tenant: str) -> List[int]:
        d = self.adapter_dir(name, tenant)
        if not d.exists():
            return []
        return sorted(v for v in (_version_of(p) for p in d.iterdir())
                      if v is not None)

    def latest_adapter(self, name: str, tenant: str) -> Optional[int]:
        vs = self.adapter_versions(name, tenant)
        return vs[-1] if vs else None

    def publish_adapter(self, name: str, tenant: str, adapter: dict, *,
                        base_version: int, rank: int, alpha: float,
                        version: Optional[int] = None,
                        extra_meta: Optional[dict] = None) -> int:
        """Publish a tenant's adapter tree against `base_version` of
        `name`: the artifact is the delta alone, never a model zip.
        Returns the adapter version committed; `rank`, `alpha` and
        `base_version` ride meta.json, so `resolve_adapter` composes
        without side-channel state."""
        from deeplearning4j_tpu_torch.tenancy import lora
        d = self.adapter_dir(name, tenant)
        d.mkdir(parents=True, exist_ok=True)
        tmp = d / f".publish-{os.getpid()}-{uuid.uuid4().hex[:8]}.tmp.zip"
        meta = dict(extra_meta or {})
        meta.update(model=name, tenant=tenant,
                    base_version=int(base_version), rank=int(rank),
                    alpha=float(alpha))
        try:
            lora.save_adapter(tmp, adapter, meta=meta)
            if version is not None:
                committed = self._claim(tmp, self.adapter_path(
                    name, tenant, int(version)), int(version))
                if committed is None:
                    raise VersionConflictError(
                        f"{name}/{tenant} adapter v{version} already "
                        f"exists — a concurrent publish won the claim")
            else:
                while True:
                    nxt = (self.latest_adapter(name, tenant) or 0) + 1
                    committed = self._claim(
                        tmp, self.adapter_path(name, tenant, nxt), nxt)
                    if committed is not None:
                        break
        finally:
            if tmp.exists():
                tmp.unlink()
        self._fsync_dir(d)
        if monitor.is_enabled():
            monitor.registry().counter(
                "registry_adapter_published_total",
                help="tenant adapter versions published",
                model=name, tenant=tenant).inc()
        self._gc_adapters(name, tenant)
        GLOBAL_FLIGHT_RECORDER.record("publish_adapter", model=name,
                                      tenant=tenant, version=committed,
                                      base_version=int(base_version))
        log.info("published adapter %s/%s v%d (base v%d) -> %s",
                 name, tenant, committed, base_version,
                 self.adapter_path(name, tenant, committed))
        return committed

    def resolve_adapter(self, name: str, tenant: str,
                        version: Union[int, str] = "latest"):
        """-> (adapter tree of CPU tensors, meta, version). `"latest"`
        walks newest-first with corrupt-artifact fallback (the model
        store's semantics); an explicit version fails hard on damage."""
        from deeplearning4j_tpu_torch.tenancy import lora
        vs = self.adapter_versions(name, tenant)
        if not vs:
            raise FileNotFoundError(
                f"no published adapters for {name!r} tenant {tenant!r} "
                f"under {self.root} (known tenants: {self.tenants(name)})")
        if version != "latest":
            v = int(version)
            if v not in vs:
                raise FileNotFoundError(
                    f"{name}/{tenant} adapter v{v} is not in the "
                    f"registry (have {vs})")
            adapter, meta = lora.load_adapter(
                self.adapter_path(name, tenant, v))
            return adapter, meta, v
        m = self._metrics()
        tried = []
        for v in reversed(vs):
            try:
                adapter, meta = lora.load_adapter(
                    self.adapter_path(name, tenant, v))
                return adapter, meta, v
            except (ValueError, KeyError, OSError) as e:
                log.warning("%s/%s adapter v%d is corrupt (%s); "
                            "falling back", name, tenant, v, e)
                if m is not None:
                    m["fallback"].inc()
                tried.append((v, e))
        detail = "; ".join(f"v{v}: {e}" for v, e in tried)
        raise CheckpointCorruptError(
            f"every published adapter of {name!r}/{tenant!r} failed "
            f"verification ({len(tried)} candidates tried) — {detail}")

    def pin_adapter(self, name: str, tenant: str, version: int):
        """Protect a served adapter version from retention GC (the
        TenantFleet pins what each tenant decodes with), in memory and
        by an on-disk marker, as `pin` does."""
        with self._lock:
            self._adapter_pinned.add((name, tenant, int(version)))
        self._mark(self.adapter_dir(name, tenant), version)

    def unpin_adapter(self, name: str, tenant: str, version: int):
        with self._lock:
            self._adapter_pinned.discard((name, tenant, int(version)))
        self._unmark(self.adapter_dir(name, tenant), version)
        self._gc_adapters(name, tenant)

    def _gc_adapters(self, name: str, tenant: str):
        with self._lock:
            pinned = {v for n, t, v in self._adapter_pinned
                      if n == name and t == tenant}
        self._collect(self.adapter_dir(name, tenant),
                      self.adapter_versions(name, tenant), pinned,
                      lambda v: self.adapter_path(name, tenant, v),
                      f"adapter {name}/{tenant}", self._metrics())

    def adapter_publish_listener(self, name: str, tenant: str, *,
                                 base_version: int, rank: int,
                                 alpha: float, frequency: int = 100,
                                 every_s: Optional[float] = None,
                                 publish_at_fit_end: bool = True,
                                 gate=None):
        """The adapter-delta twin of `publish_listener`: every cadence
        boundary ships `tenancy.lora.extract_adapter(net)` through
        `publish_adapter`, with the same step-boundary discipline and
        drift-gate semantics."""
        return AdapterPublishListener(
            self, name, tenant, base_version=base_version, rank=rank,
            alpha=alpha, frequency=frequency, every_s=every_s,
            publish_at_fit_end=publish_at_fit_end, gate=gate)

    # -------------------------------------------------- publish listener
    def publish_listener(self, name: str, *, frequency: int = 100,
                         epoch_frequency: Optional[int] = None,
                         every_s: Optional[float] = None,
                         save_updater: bool = False,
                         publish_at_fit_end: bool = True,
                         gate=None, normalizer_provider=None):
        """A TrainingListener that publishes the training model into
        this registry every `frequency` completed steps — checkpoint-
        as-publish as a one-liner:

            net.add_listener(registry.publish_listener("lm", frequency=500))

        `gate`: callable → bool consulted before every publish (the
        drift gate of `online/trainer.py`): False skips the publish
        WITHOUT advancing the cadence clock, so the next legal step
        boundary after the gate reopens publishes immediately — pause
        publishing, never training. `normalizer_provider`: callable →
        normalizer-or-None evaluated AT publish time (a
        `WindowedStandardize.snapshot` bound method), so each release
        carries the statistics of its own training window.

        `every_s`: WALL-CLOCK cadence alongside the step cadence — "a
        fresh model every N seconds regardless of throughput", the
        freshness promise a production fleet actually makes. A step
        boundary publishes when EITHER cadence is due; a slow stream
        (few steps per wall-second) publishes on the clock, a fast one
        on the step count. The clock anchors at fit start (a
        warm-started run owes a full period) and only advances on an
        ACTUAL publish — a gate refusal freezes it exactly like the
        step clock, so recovery publishes at the first legal
        boundary."""
        return RegistryPublishListener(
            self, name, frequency=frequency,
            epoch_frequency=epoch_frequency, every_s=every_s,
            save_updater=save_updater,
            publish_at_fit_end=publish_at_fit_end, gate=gate,
            normalizer_provider=normalizer_provider)


class RegistryPublishListener(TrainingListener):
    """Periodic publish from inside a fit loop — the CheckpointListener
    cadence discipline (fault/listener.py): only capture at
    ``step_boundary`` callbacks (a fused multi-step group's mid-group
    replays see post-group params with a mid-group iteration count —
    publishing there would serve a params/counter mismatch), and count
    "`frequency` steps since the last publish" rather than a modulo so
    misaligned boundaries publish at the next legal one."""

    def __init__(self, registry: ModelRegistry, name: str, *,
                 frequency: int = 100,
                 epoch_frequency: Optional[int] = None,
                 every_s: Optional[float] = None,
                 save_updater: bool = False,
                 publish_at_fit_end: bool = True,
                 gate=None, normalizer_provider=None):
        self.registry = registry
        self.name = name
        self.frequency = max(1, int(frequency))
        self.epoch_frequency = epoch_frequency
        if every_s is not None and float(every_s) <= 0:
            raise ValueError(f"every_s must be > 0; got {every_s}")
        self.every_s = None if every_s is None else float(every_s)
        self.save_updater = save_updater
        self.publish_at_fit_end = publish_at_fit_end
        self.gate = gate
        self.normalizer_provider = normalizer_provider
        self._last_published_step = 0
        self._last_published_time: Optional[float] = None
        self._last_gated_log_step = 0
        self._anchored = False
        self.published_versions: List[int] = []
        self.published_steps: List[int] = []
        self.gated_skips = 0

    def on_fit_start(self, model):
        # anchor the cadence clock at the CURRENT counter once: a
        # warm-started / resumed model (iteration_count >> 0) must wait
        # a full `frequency` of NEW steps for its first publish, not
        # publish immediately because the clock still reads 0
        if not self._anchored:
            self._anchored = True
            self._last_published_step = max(
                self._last_published_step, int(model.iteration_count))
            if self.every_s is not None:
                import time
                self._last_published_time = time.monotonic()

    def _clock_due(self) -> bool:
        """True when `every_s` wall-clock seconds passed since the
        last publish (or the fit-start anchor). Without an anchor yet
        (a listener driven outside a fit loop), the first boundary
        anchors the clock instead of publishing — the warm-start
        discipline applied to time."""
        if self.every_s is None:
            return False
        import time
        now = time.monotonic()
        if self._last_published_time is None:
            self._last_published_time = now
            return False
        return now - self._last_published_time >= self.every_s

    def _gated(self, step: int, *, windowed: bool = True) -> bool:
        """True when the gate currently refuses publishing. The
        cadence clock does NOT advance on a refusal — publishing
        resumes at the first legal boundary after recovery.

        The skip COUNT advances once per cadence WINDOW on the
        iteration path (`windowed=True`): while the gate stays closed
        every step boundary re-enters here (the frozen clock keeps the
        publish overdue), and counting each would over-report one
        refused release as `frequency` refusals. Epoch-end / fit-end
        refusals are discrete events (`windowed=False`) and count once
        per step."""
        if self.gate is None or self.gate():
            return False
        since = step - max(self._last_published_step,
                           self._last_gated_log_step)
        if (since >= self.frequency if windowed
                else step > self._last_gated_log_step):
            self._last_gated_log_step = step
            self.gated_skips += 1
            if monitor.is_enabled():
                monitor.registry().counter(
                    "online_publishes_skipped_total",
                    help="publishes refused by the drift gate (one "
                         "per refused cadence window / fit boundary)",
                    model=self.name).inc()
        return True

    def _publish(self, model, step: int):
        normalizer = (self.normalizer_provider()
                      if self.normalizer_provider is not None else None)
        v = self.registry.publish(self.name, model,
                                  save_updater=self.save_updater,
                                  normalizer=normalizer)
        self.published_versions.append(v)
        self.published_steps.append(step)
        self._last_published_step = step
        if self.every_s is not None:
            import time
            self._last_published_time = time.monotonic()
        if monitor.is_enabled():
            monitor.registry().counter(
                "online_publishes_total",
                help="model snapshots published into the serving "
                     "registry from a training loop",
                model=self.name).inc()

    def iteration_done(self, model, iteration, epoch, score, **info):
        if not info.get("step_boundary", True):
            return
        step = iteration + 1
        due_steps = step - self._last_published_step >= self.frequency
        if not due_steps and not self._clock_due():
            return
        if self._gated(step):
            return
        self._publish(model, step)

    def on_epoch_end(self, model, epoch):
        if (self.epoch_frequency
                and (epoch + 1) % self.epoch_frequency == 0
                and not self._gated(int(model.iteration_count),
                                    windowed=False)):
            self._publish(model, int(model.iteration_count))

    def on_fit_end(self, model):
        # online runs stop at arbitrary steps: the final snapshot
        # publishes even when the stop iteration is off-cadence (the
        # drift gate still applies — a degraded final model must not
        # ship just because the stream ended while it was degraded)
        if self.publish_at_fit_end and \
                int(model.iteration_count) > self._last_published_step \
                and not self._gated(int(model.iteration_count),
                                    windowed=False):
            self._publish(model, int(model.iteration_count))


class AdapterPublishListener(RegistryPublishListener):
    """RegistryPublishListener whose publish unit is the tenant's adapter
    delta (`tenancy.lora.extract_adapter`) against a pinned base version:
    the cadence, gate and step-boundary semantics are inherited; only
    what ships changes."""

    def __init__(self, registry: ModelRegistry, name: str, tenant: str,
                 *, base_version: int, rank: int, alpha: float,
                 frequency: int = 100, every_s: Optional[float] = None,
                 publish_at_fit_end: bool = True, gate=None):
        super().__init__(registry, name, frequency=frequency,
                         every_s=every_s,
                         publish_at_fit_end=publish_at_fit_end, gate=gate)
        self.tenant = tenant
        self.base_version = int(base_version)
        self.rank = int(rank)
        self.alpha = float(alpha)

    def _publish(self, model, step: int):
        from deeplearning4j_tpu_torch.tenancy import lora
        adapter = lora.extract_adapter(model)
        if not adapter:
            raise ValueError(
                f"model for {self.name}/{self.tenant} carries no attached "
                f"adapter — lora.attach_adapter() before fit")
        v = self.registry.publish_adapter(
            self.name, self.tenant, adapter,
            base_version=self.base_version, rank=self.rank,
            alpha=self.alpha, extra_meta={"step": step})
        self.published_versions.append(v)
        self.published_steps.append(step)
        self._last_published_step = step
        if self.every_s is not None:
            import time
            self._last_published_time = time.monotonic()
        if monitor.is_enabled():
            monitor.registry().counter(
                "online_adapter_publishes_total",
                help="adapter deltas published into the serving registry "
                     "from a tenant's training loop",
                model=self.name, tenant=self.tenant).inc()
