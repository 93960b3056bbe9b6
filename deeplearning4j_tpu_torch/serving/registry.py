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

The per-tenant adapter store of the JAX registry (`publish_adapter`,
`resolve_adapter`, the adapter pins and `adapter_publish_listener`)
comes with the port of `tenancy/lora.py`.
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
                committed = self._claim(tmp, name, int(version))
                if committed is None:
                    raise VersionConflictError(
                        f"{name} v{version} already exists — a concurrent "
                        f"publish won the claim; publish without version= "
                        f"to take the next free number")
            else:
                while True:
                    nxt = (self.latest(name) or 0) + 1
                    committed = self._claim(tmp, name, nxt)
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

    def _claim(self, tmp: Path, name: str, version: int) -> Optional[int]:
        """Claim `version` by hard-linking the finished tmp zip to the
        final path: `os.link` is atomic and fails with EEXIST when the
        version is already taken — the one-winner primitive."""
        final = self.path(name, version)
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
    def _pin_marker(self, name: str, version: int) -> Path:
        return self.model_dir(name) / f".pin-v{int(version)}.{os.getpid()}"

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
        d = self.model_dir(name)
        d.mkdir(parents=True, exist_ok=True)
        try:
            self._pin_marker(name, version).touch()
        except OSError:
            pass

    def unpin(self, name: str, version: int):
        with self._lock:
            self._pinned.discard((name, int(version)))
        try:
            self._pin_marker(name, version).unlink()
        except OSError:
            pass   # marker already gone (or never written)
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

    def _marker_pins(self, name: str) -> Set[int]:
        """Versions pinned by ANY live process (marker files); stale
        markers from dead pids are swept here."""
        import re
        keep: Set[int] = set()
        d = self.model_dir(name)
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

    def _retained(self, name: str, vs: List[int]) -> Set[int]:
        keep = set(vs[-self.keep_last:])
        if self.keep_every:
            keep.update(v for v in vs if v % self.keep_every == 0)
        with self._lock:
            keep.update(v for n, v in self._pinned if n == name)
        keep.update(self._marker_pins(name))
        return keep

    def _gc(self, name: str, m=None):
        vs = self.versions(name)
        keep = self._retained(name, vs)
        dropped = 0
        for v in vs:
            if v in keep:
                continue
            try:
                self.path(name, v).unlink()
                dropped += 1
                log.info("retention GC dropped %s v%d", name, v)
            except OSError:
                pass
        # stale publish tmp orphans (a killed publisher's leftovers).
        # AGE-GATED: a fresh tmp is very likely a CONCURRENT publisher
        # mid-write — unlinking it between its write_model and its
        # link-claim would turn the loser's VersionConflictError into
        # a FileNotFoundError and break the one-winner contract
        import time as _time
        d = self.model_dir(name)
        cutoff = _time.time() - 3600.0
        for p in d.glob(".publish-*.tmp.zip"):
            try:
                if p.stat().st_mtime < cutoff:
                    p.unlink()
            except OSError:
                pass
        if dropped and m is not None:
            m["gc"].inc(dropped)

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
