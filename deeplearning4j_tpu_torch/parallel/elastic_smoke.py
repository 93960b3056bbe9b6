"""The survive-the-kill drill of the elastic runtime (counterpart of
`scripts/fault_drill.py --elastic-smoke`, `--elastic-child` and
`--elastic-ref`).

A coordinator runs in the caller's process; n workers are spawned, each
an `ElasticTrainer` in threshold mode (`on_fatal="raise"`). At step
`KILL_AT` the worker of rank `KILL_RANK` SIGKILLs itself. Its peers see
the broken collective; each worker's own loop (its supervisor) tears the
broken group down (bounded), keeps heartbeating, and joins again in the
same process once the coordinator has evicted the dead member
(`GRACE_S`) and committed the smaller world (`SETTLE_S`); the survivors
resume it from the newest checkpoint. Any other exit of a worker without
its result file fails the drill at once. Once the fleet passes step
`GROW_AFTER`, the killed worker is relaunched and the world grows back;
the run finishes its epoch. Held against two runs in the caller's
process (one replica a worker, on a mesh that repeats the device):

- the scheduled run (`scheduled_reference`): the same global program
  over the same schedule, an `ElasticTrainer` whose membership is
  scripted (`WIDTHS`), broken after step `KILL_AT` and drained at
  `HOLD_AT`. Every step's loss of every worker's every life stays within
  `LOSS_RTOL` of its loss in the same generation, and the final params
  within `PARAM_MOTION_RTOL` of its motion;
- the uninterrupted run (`reference`): every step's loss within JAX's
  drift band (|delta| <= 0.25 x the initial loss). The gap is the
  schedule's own: the shrunk generation trains one replica's threshold
  exchange, and the killed step runs again.

Besides:

- every worker's final result file exists (the completion contract is
  the result file, not the exit code) and records every step; the
  per-step losses are flushed by each worker at every step so they
  survive its death;
- the world ran the initial, the shrunk and the regrown generation, each
  resume restored the threshold residual, and the shrunk generation
  resumed from the last checkpoint written before the kill;
- the final params are bit-equal across workers.

A shrunk world holds at step `HOLD_AT` until the regrown generation
commits (`HOLD_AT` paces the drill against the control plane, as JAX's
drill sleeps a step), so the drain happens there.

Usage:

    python -m deeplearning4j_tpu_torch.parallel.elastic_smoke --device cpu

`run_drill(device=, model=, data=, ...)` takes the model builder and the
data as "module:function" names the spawned workers import (the small
Dense problem of JAX's drill by default), and returns a report with the
losses, the generations, the recovery timeline of the shrink and the
regrow, ms/step a generation, the drain check's host ms a step, the
checkpoint's write and resume seconds, the kernel launches of every
worker's lives (by kernel and, under "<kernel>/<dtype>", by dtype) and
the federated telemetry the caller's `AlertEngine`
saw. On CUDA devices one card runs every worker over gloo (NCCL refuses
two ranks on one card); with two or more cards each worker takes its
rank's card over NCCL, and a survivor then waits out `PEER_TIMEOUT_S`
(the watchdog's abort) before it sees the dead peer.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

#: the small problem of JAX's drill: 240 examples, a global batch of 24,
#: ten steps an epoch (fault_drill.py:212-224)
E_FEATURES, E_HIDDEN, E_CLASSES = 8, 16, 3
E_EXAMPLES, E_BATCH = 240, 24
DRIFT_BAND = 0.25          # of the initial loss (tests/test_elastic.py)
#: against the scheduled run: each step's loss (relative) and the final
#: params (of the scheduled run's motion, per param)
LOSS_RTOL, PARAM_MOTION_RTOL = 1e-4, 1e-2

#: the scenario: 2 workers, one epoch in threshold mode, checkpoints
#: every 2 steps; rank 1 SIGKILLs itself after step 3, is relaunched
#: once the fleet passes step 5, and the shrunk world holds at step 6
N_WORKERS, KILL_RANK, KILL_AT, GROW_AFTER, HOLD_AT = 2, 1, 3, 5, 6
CKPT_FREQUENCY = 2
#: the generations' widths: initial, shrunk, regrown
WIDTHS = (N_WORKERS, N_WORKERS - 1, N_WORKERS)
#: the control plane: heartbeats, the coordinator's eviction grace, the
#: settle window and its tick; `INIT_TIMEOUT_S` bounds a rendezvous and
#: `PEER_TIMEOUT_S` a collective (a few graces: under NCCL it is how long
#: a survivor waits for a dead peer; it must outlast a relaunched peer's
#: first step, 9-12 s on the card); a worker's federated export older
#: than `WORKER_STALE_S` is stale
HEARTBEAT_S, GRACE_S, SETTLE_S, TICK_S = 0.25, 6.0, 1.0, 0.05
INIT_TIMEOUT_S, PEER_TIMEOUT_S, WORKER_STALE_S = 30.0, 4 * GRACE_S, 3.0

#: what a caller chooses: the device, the model builder and the data
#: ("module:function" names the workers import, with their keyword
#: arguments), the global batch, `ParallelTrainer`'s extra arguments, a
#: directory the workers add to their import path, the elastic-shrink
#: rule's hysteresis (the default pack's) and the wall limit
DEFAULTS = dict(
    device="cpu", model=f"{__name__}:dense_net", model_kwargs={},
    data=f"{__name__}:dense_data", data_kwargs={}, batch=E_BATCH,
    trainer_kwargs={}, pythonpath=None, for_s=5.0, timeout=300.0)


class DrillFailed(RuntimeError):
    """A failed drill check; `report` holds what the drill measured."""

    def __init__(self, message, report):
        super().__init__(message)
        self.report = report


# ------------------------------------------------------------- problem
def dense_net(device):
    """JAX's drill net: Dense(8 -> 16, tanh) -> softmax Output(3),
    Adam(0.01), seed 7."""
    from deeplearning4j_tpu_torch.common.updaters import Adam
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = (NeuralNetConfiguration.builder().seed(7)
            .updater(Adam(0.01)).list()
            .layer(DenseLayer(n_in=E_FEATURES, n_out=E_HIDDEN,
                              activation="tanh"))
            .layer(OutputLayer(n_in=E_HIDDEN, n_out=E_CLASSES,
                               activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(E_FEATURES)).build())
    return MultiLayerNetwork(conf, device=device).init()


def dense_data():
    """JAX's drill data: 240 Gaussian rows labelled by a random linear
    map's argmax."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((E_EXAMPLES, E_FEATURES)).astype(np.float32)
    w = rng.standard_normal((E_FEATURES, E_CLASSES))
    y = np.eye(E_CLASSES, dtype=np.float32)[np.argmax(x @ w, axis=1)]
    return x, y


def _resolve(name):
    import importlib
    mod, fn = name.split(":")
    return getattr(importlib.import_module(mod), fn)


def trainer_kwargs(spec):
    """The spec's `ParallelTrainer` arguments (a `threshold_config` given
    as a dict of `ThresholdConfig`'s fields)."""
    kw = dict(spec["trainer_kwargs"])
    if isinstance(kw.get("threshold_config"), dict):
        from deeplearning4j_tpu_torch.parallel.gradient_sharing import (
            ThresholdConfig)
        kw["threshold_config"] = ThresholdConfig(**kw["threshold_config"])
    return kw


def _problem(spec):
    """(build_model(device), iterator factory, steps) of a spec. The data
    is made at the first iterator, so a worker registers first."""
    from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator
    build = _resolve(spec["model"])
    data = []

    def arrays():
        if not data:
            data.extend(_resolve(spec["data"])(**spec["data_kwargs"]))
        return data

    def iterator():
        x, y = arrays()
        return ArrayDataSetIterator(x, y, batch_size=spec["batch"],
                                    shuffle=True, seed=11)

    def steps():
        return len(arrays()[0]) // spec["batch"]

    return (lambda dev: build(dev, **spec["model_kwargs"])), iterator, steps


def _devices(spec):
    """(this worker's mesh devices or None, backend) for a spec."""
    if spec["device"] == "cpu":
        return ["cpu"], "gloo"
    import torch
    if torch.cuda.device_count() >= 2:
        return None, "nccl"          # the rank's card (written, not run)
    return ["cuda:0"], "gloo"


# -------------------------------------------------------------- worker
def _write_json(path, obj):
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def _child_main(spec, token, control, ckpt_dir, out, kill_at):
    """One elastic worker. Each life flushes `<out>.life-<pid>.json` at
    every step (losses, timestamps, launches, drain and checkpoint
    seconds), so what it did survives a SIGKILL; a completed run writes
    `<out>.json` and `<out>.npz` (the final params)."""
    import torch
    if spec["device"] == "cpu":
        torch.set_num_threads(1)
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    from deeplearning4j_tpu_torch import fault, kernels, monitor
    from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener
    from deeplearning4j_tpu_torch.parallel.elastic import (
        ElasticConfig, ElasticTrainer, _DrainListener, distributed_failure)
    reg = monitor.enable(jit_compile=False, device_memory=False)
    build, make_iter, _ = _problem(spec)
    devices, backend = _devices(spec)
    life = {"pid": os.getpid(), "started": time.time(), "steps": [],
            "init": {}, "resume": {}, "drain": {}, "ckpt": {},
            "launches": {}, "device": None, "history": [], "fatal": []}
    life_path = f"{out}.life-{os.getpid()}.json"
    n = N_WORKERS

    class Drill(ElasticTrainer):
        def _init_runtime(self, plan):
            self.joining = str(plan["generation"])
            t0 = time.time()
            try:
                super()._init_runtime(plan)
            finally:
                # a later join to the same generation (after a broken
                # world) does not replace the first
                life["init"].setdefault(self.joining, [t0, time.time()])

        def _resume(self, trainer, model, iterator):
            t0 = time.time()
            ok = super()._resume(trainer, model, iterator)
            life["resume"][self.joining] = [t0, time.time(), ok]
            return ok

    cfg = ElasticConfig(
        control_address=control, token=token,
        heartbeat_interval_s=HEARTBEAT_S, on_fatal="raise",
        init_timeout_s=INIT_TIMEOUT_S, init_attempts=1,
        jax_heartbeat_interval_s=PEER_TIMEOUT_S / 4,
        jax_max_missing_heartbeats=4)
    et = Drill(lambda: build(devices[0] if devices else "cuda"),
               config=cfg, ckpt_dir=ckpt_dir,
               ckpt_frequency=CKPT_FREQUENCY,
               gradient_sharing="threshold",
               trainer_kwargs=trainer_kwargs(spec), devices=devices,
               backend=backend)
    et.client.federate_metrics(token)

    class Flush(TrainingListener):
        def __init__(self, generation):
            self.generation = generation

        def iteration_done(self, model, iteration, epoch, score, **info):
            life["steps"].append([int(iteration), time.time(),
                                  self.generation, float(score)])
            life["device"] = str(model.device)
            life["history"] = list(et.history)
            life["launches"] = {
                k: v for k, v in {**kernels.LAUNCHES,
                                  **kernels.LAUNCHES_BY_DTYPE}.items() if v}
            for lst in model.listeners:
                if isinstance(lst, _DrainListener):
                    life["drain"][str(self.generation)] = dict(
                        lst.drain_check.stats)
            snap = reg.snapshot()
            for key, fam, field in (
                    ("seconds", "checkpoint_write_seconds", "sum"),
                    ("count", "checkpoint_write_seconds", "count"),
                    ("bytes", "checkpoint_bytes_total", "value")):
                vals = snap.get(fam, {}).get("values") or [{}]
                life["ckpt"][key] = vals[0].get(field, 0)
            _write_json(life_path, life)
            plan = et.client.current_plan() or {}
            if (iteration + 1 == HOLD_AT
                    and plan.get("num_processes", n) < n):
                # a shrunk world waits here for the regrown generation
                deadline = time.time() + spec["timeout"]
                while (et.client.generation() == self.generation
                       and time.time() < deadline):
                    time.sleep(0.02)

    def extra_listeners(generation):
        extras = [Flush(generation)]
        if kill_at:
            extras.append(fault.PreemptionListener(kill_at, mode="sigkill"))
        return extras

    life["fit_at"] = time.time()
    _write_json(life_path, life)
    for _ in range(3):
        try:
            model = et.fit(make_iter, epochs=1,
                           batch_size=spec["batch"],
                           extra_listeners=extra_listeners)
            break
        except Exception as e:  # noqa: BLE001 — classified here
            # on_fatal="raise" hands a broken world to this loop, the
            # worker's supervisor: tear it down (bounded), keep the
            # membership beating, and join again in this process once
            # the coordinator has committed the next generation (the
            # broken one's plan still names the dead peer)
            if not (distributed_failure(e) or (
                    e.__cause__ is not None
                    and distributed_failure(e.__cause__))):
                raise
            broken = et.client.generation()
            life["fatal"].append([time.time(), str(e)[:300]])
            _write_json(life_path, life)
            et._teardown_runtime()
            et.client.start_heartbeats()
            deadline = time.time() + GRACE_S + 10 * SETTLE_S
            while (et.client.generation() == broken
                   and time.time() < deadline):
                time.sleep(0.02)
    else:
        raise RuntimeError(f"{token}: the world broke three times")
    flat = {k: v.detach().float().cpu().numpy()
            for k, v in model.param_table().items()}
    with open(out + ".npz", "wb") as f:
        np.savez(f, **flat)
    # the final metrics ride the result file: a worker that leaves right
    # after its last step may leave before a heartbeat carried them
    from deeplearning4j_tpu_torch.monitor.federate import export_snapshot
    _write_json(out + ".json", {"iteration_count": int(model.iteration_count),
                                "history": et.history,
                                "device": str(model.device),
                                "metrics": export_snapshot(
                                    monitor.registry(), token)})
    # skip the interpreter's teardown: the result files are the contract
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


# ----------------------------------------------------------- reference
def reference(spec):
    """The uninterrupted run in this process: the same global program
    (`n` replicas on a mesh that repeats the device). Returns (losses by
    iteration, final params by name, the model's device)."""
    from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener
    from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from deeplearning4j_tpu_torch.parallel.trainer import ParallelTrainer
    build, make_iter, _ = _problem(spec)
    dev = "cpu" if spec["device"] == "cpu" else "cuda:0"
    net = build(dev)
    losses = {}

    class Collect(TrainingListener):
        def iteration_done(self, model, iteration, epoch, score, **info):
            losses[int(iteration)] = float(score)

    net.add_listener(Collect())
    n = N_WORKERS
    ParallelTrainer(net, make_mesh(MeshSpec.of(data=n), devices=[dev] * n),
                    gradient_sharing="threshold",
                    **trainer_kwargs(spec)).fit(
        make_iter(), epochs=1, batch_size=spec["batch"])
    return losses, _params(net), str(net.device)


def _params(net):
    return {k: v.detach().float().cpu().numpy().copy()
            for k, v in net.param_table().items()}


class ScriptedMembership:
    """The drill's membership as a script: the client of an in-process
    `ElasticTrainer` whose generation g has `WIDTHS[g - 1]` members (the
    caller sets `gen`)."""

    def __init__(self):
        self.gen = 1

    def generation(self):
        return self.gen

    def await_member_plan(self, timeout_s=None):
        return {"generation": self.gen,
                "num_processes": WIDTHS[self.gen - 1]}

    def register(self, *args, **kwargs):
        pass

    start_heartbeats = stop = set_info = leave = register


def scheduled_reference(spec, ckpt_dir):
    """The drill's schedule in this process: an `ElasticTrainer` with its
    runtime seams stubbed, its mesh the plan's width of replicas on one
    device, its membership scripted. Generation 1 breaks after step
    `KILL_AT` as the killed worker's peers see it (a distributed
    failure, before that step's checkpoint and drain check), generation 2
    resumes from the last checkpoint and drains at `HOLD_AT`, generation
    3 resumes from the drain's checkpoint and finishes the epoch. It
    writes the checkpoints its resumes read (the drill's every
    `CKPT_FREQUENCY` steps until the kill, then the drain's). Returns (losses by (generation, iteration),
    final params, initial params)."""
    from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener
    from deeplearning4j_tpu_torch.parallel.elastic import (
        ElasticConfig, ElasticTrainer, distributed_failure)
    from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    build, make_iter, _ = _problem(spec)
    dev = "cpu" if spec["device"] == "cpu" else "cuda:0"
    members = ScriptedMembership()
    losses = {}

    class InProcess(ElasticTrainer):
        def _init_runtime(self, plan):
            pass

        def _teardown_runtime(self):
            pass

        def _mesh(self, plan):
            n = plan["num_processes"]
            return make_mesh(MeshSpec.of(data=n), devices=[dev] * n)

    class Script(TrainingListener):
        def __init__(self, generation):
            self.generation = generation

        def iteration_done(self, model, iteration, epoch, score, **info):
            losses[(self.generation, int(iteration))] = float(score)
            if self.generation == 1 and iteration + 1 == KILL_AT:
                # later generations write only the drain's checkpoint:
                # no resume reads another
                et.ckpt_frequency = 10 ** 6
                members.gen = 2
                raise RuntimeError("Connection closed by peer (the "
                                   "scheduled kill)")
            if self.generation == 2 and iteration + 1 == HOLD_AT:
                members.gen = 3       # the regrown world; the drain follows

    init = _params(build(dev))
    et = InProcess(lambda: build(dev), config=ElasticConfig(
        control_address="scripted:0", token="w0"), ckpt_dir=ckpt_dir,
        ckpt_frequency=CKPT_FREQUENCY, gradient_sharing="threshold",
        trainer_kwargs=trainer_kwargs(spec))
    et.client = members
    for _ in range(2):
        try:
            model = et.fit(make_iter, epochs=1, batch_size=spec["batch"],
                           extra_listeners=lambda g: [Script(g)])
            break
        except RuntimeError as e:
            if not distributed_failure(e):
                raise
    else:
        raise RuntimeError("the scheduled run broke twice")
    return losses, _params(model), init


def references(spec, work_dir):
    """Both runs the drill is held against, made in this process:
    {"losses", "params", "device"} of the uninterrupted run (`reference`)
    and {"scheduled_losses", "scheduled_params", "init"} of the scheduled
    one (`scheduled_reference`, its checkpoints under `work_dir`), with
    the seconds each took."""
    t0 = time.time()
    losses, params, device = reference(spec)
    t1 = time.time()
    s_losses, s_params, init = scheduled_reference(
        spec, os.path.join(work_dir, "scheduled_ckpts"))
    return dict(losses=losses, params=params, device=device,
                scheduled_losses=s_losses, scheduled_params=s_params,
                init=init, seconds=[t1 - t0, time.time() - t1])


def param_motion(got, want, init):
    """(worst ||got - want|| / ||want - init|| over params, its name)."""
    worst = (0.0, "")
    for k, w in want.items():
        diff = float(np.linalg.norm(got[k] - w))
        moved = float(np.linalg.norm(w - init[k]))
        rel = diff / moved if moved else (0.0 if diff == 0 else np.inf)
        worst = max(worst, (rel, k))
    return worst


# ----------------------------------------------------------- the drill
def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(spec, token, control, ckpt_dir, out, kill_at=None):
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    paths = [root] + [p for p in (spec.get("pythonpath"),
                                  os.environ.get("PYTHONPATH")) if p]
    env["PYTHONPATH"] = os.pathsep.join(paths)
    cmd = [sys.executable, "-m", __name__, "--child", json.dumps(spec),
           token, control, ckpt_dir, out, str(kill_at or 0)]
    with open(out + ".log", "a") as log:
        return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                env=env, cwd=root)


def _lives(out):
    """Every life's flush record of one worker, in start order."""
    d, base = os.path.split(out)
    lives = []
    for name in os.listdir(d):
        if name.startswith(base + ".life-") and name.endswith(".json"):
            with open(os.path.join(d, name)) as f:
                lives.append(json.load(f))
    return sorted(lives, key=lambda lf: lf["started"])


def _finished(out, steps):
    try:
        with open(out + ".json") as f:
            return json.load(f).get("iteration_count") == steps
    except (OSError, ValueError):
        return False


def _log_tail(out, n=3000):
    try:
        with open(out + ".log") as f:
            return f.read()[-n:]
    except OSError:
        return ""


def run_drill(*, work_dir=None, refs=None, **overrides) -> dict:
    """The drill (see the module docstring). Keyword arguments override
    `DEFAULTS`; `refs` is `references(spec, ...)`'s result when the
    caller made it already (else it is made first, here). Returns the
    report and raises RuntimeError on a failed check or a worker that
    exited without its result file."""
    spec = dict(DEFAULTS, **overrides)
    from deeplearning4j_tpu_torch.device import resolve_device
    resolve_device(spec["device"])
    own_dir = work_dir is None
    work_dir = work_dir or tempfile.mkdtemp(prefix="elastic_drill_")
    os.makedirs(work_dir, exist_ok=True)
    try:
        return _run(spec, work_dir, refs)
    finally:
        if own_dir:
            import shutil
            shutil.rmtree(work_dir, ignore_errors=True)


def _run(spec, work_dir, refs):
    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.monitor.alerts import (
        AlertEngine, default_rule_pack)
    from deeplearning4j_tpu_torch.monitor.federate import (
        MetricsAggregator, ingest_elastic_status)
    from deeplearning4j_tpu_torch.monitor.flightrec import FlightRecorder
    from deeplearning4j_tpu_torch.parallel.elastic import ElasticCoordinator
    n = N_WORKERS
    steps = _problem(spec)[2]()
    refs = refs or references(spec, work_dir)

    prev = (monitor.is_enabled(), monitor.registry())
    reg = monitor.enable(monitor.MetricsRegistry(), jit_compile=False,
                         device_memory=False)
    agg, rec = MetricsAggregator(), FlightRecorder()
    engine = AlertEngine(agg, default_rule_pack(
        elastic_min_processes=n, worker_stale_s=WORKER_STALE_S,
        for_s=spec["for_s"]), recorder=rec, registry=reg)
    co = ElasticCoordinator(grace_s=GRACE_S,
                            settle_s=SETTLE_S, tick_s=TICK_S,
                            min_members=n,
                            jax_port_base=_free_port()).start()
    ckpt_dir = os.path.join(work_dir, "ckpts")
    tokens = [f"w{i}" for i in range(n)]
    victim = tokens[KILL_RANK]
    outs = {t: os.path.join(work_dir, f"worker_{t}") for t in tokens}
    events = {"commits": {}, "member_seen": {}, "member_gone": {},
              "export_age_max": {}, "alerts": []}
    t_start = time.time()
    procs = {t: _spawn(spec, t, co.address, ckpt_dir, outs[t],
                       KILL_AT if t == victim else None)
             for t in tokens}
    done = {t: False for t in tokens}
    killed_at = regrown_at = None
    deadline = time.time() + spec["timeout"]
    last_gen, live = 0, set()
    try:
        while not all(done.values()):
            if time.time() > deadline:
                raise RuntimeError(
                    f"elastic drill timed out; done={done}: "
                    + " | ".join(_log_tail(outs[t], 1500) for t in tokens))
            time.sleep(0.1)
            now = time.time()
            status = co.status()
            gen = int(status["generation"])
            if gen != last_gen:
                events["commits"][str(gen)] = now
                last_gen = gen
            members = set(status["members"])
            for t in members - live:
                events["member_seen"].setdefault(t, []).append(now)
            for t in live - members:
                events["member_gone"].setdefault(t, []).append(now)
            live = members
            if status.get("completed") and "first_done" not in events:
                # a completion is its leave, which the coordinator turns
                # into the next generation `SETTLE_S` later; the process
                # may take longer than that to exit
                events["first_done"] = now
                events["generation_at_done"] = gen
            agg.ingest_registry(reg, "coordinator")
            ingest_elastic_status(status, agg)
            for w, age in agg.export_ages(now).items():
                events["export_age_max"][w] = max(
                    events["export_age_max"].get(w, 0.0), age)
                if (w == victim and regrown_at is not None
                        and age < WORKER_STALE_S):
                    events["victim_returned"] = now
            if "first_done" not in events:
                # the alerts watch the run; the completions' leaves
                # shrink the fleet by design
                engine.evaluate()
            steps_seen = [m["info"].get("step", 0)
                          for m in status["members"].values()]
            max_step = max(steps_seen or [0])
            for t in tokens:
                p = procs.get(t)
                if done[t] or p is None or p.poll() is None:
                    continue
                rc = p.returncode
                if rc == 0 or _finished(outs[t], steps):
                    done[t] = True
                    events.setdefault("first_done", now)
                    events.setdefault("generation_at_done", gen)
                    continue
                if t == victim and killed_at is None and rc == -signal.SIGKILL:
                    killed_at = now
                    procs[t] = None
                    continue
                # a survivor re-forms the world in its own process, and
                # the victim's scheduled regrow is the only relaunch
                raise RuntimeError(f"worker {t} exited with {rc} without "
                                   f"its result file: {_log_tail(outs[t])}")
            if (killed_at is not None and regrown_at is None
                    and max_step >= GROW_AFTER):
                regrown_at = events["regrown_at"] = time.time()
                procs[victim] = _spawn(spec, victim, co.address, ckpt_dir,
                                       outs[victim])
        # the completed workers' last exports, and the alerts' verdict
        status = co.status()
        agg.ingest_registry(reg, "coordinator")
        ingest_elastic_status(status, agg)
        for t in tokens:
            with open(outs[t] + ".json") as f:
                agg.ingest(json.load(f)["metrics"])
    finally:
        for p in procs.values():
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
        co.stop()
        # the commits' own timestamps (the loop saw them up to a poll late)
        from deeplearning4j_tpu_torch.monitor.flightrec import (
            GLOBAL_FLIGHT_RECORDER)
        for e in GLOBAL_FLIGHT_RECORDER.events(
                kind="elastic_reconfiguration"):
            if e["ts"] >= t_start:
                events["commits"][str(e["generation"])] = e["ts"]
        monitor.disable()
        monitor.enable(prev[1], jit_compile=False, device_memory=False)
        if not prev[0]:
            monitor.disable()
    events["alerts"] = rec.events()
    return _verdict(spec, steps, tokens, victim, outs, refs, status, agg,
                    events, killed_at, regrown_at)


def _merged_losses(lives):
    """Loss by iteration over a worker's lives (a re-executed step's
    later loss wins)."""
    out = {}
    for life in lives:
        for it, _ts, _gen, loss in life["steps"]:
            out[int(it)] = loss
    return out


def _history(lives):
    """A worker's generation reports over its lives, generation order."""
    by_gen = {}
    for life in lives:
        for h in life["history"]:
            by_gen[h["generation"]] = h
    return [by_gen[g] for g in sorted(by_gen)]


def _gen_steps(lives, gen):
    """[(iteration, end timestamp)] of one generation over a worker's
    lives."""
    return [(it, ts) for life in lives for it, ts, g, _ in life["steps"]
            if g == gen]


def _verdict(spec, steps, tokens, victim, outs, refs, status, agg, events,
             killed_at, regrown_at):
    fails = []
    ref_losses, sched = refs["losses"], refs["scheduled_losses"]
    n = N_WORKERS
    survivor = tokens[0] if victim != tokens[0] else tokens[1]
    lives = {t: _lives(outs[t]) for t in tokens}
    results, params = {}, {}
    for t in tokens:
        try:
            with open(outs[t] + ".json") as f:
                results[t] = json.load(f)
            with np.load(outs[t] + ".npz") as d:
                params[t] = {k: d[k] for k in d.files}
        except (OSError, ValueError) as e:
            fails.append(f"{t}: no result file ({e})")
    if fails:
        raise RuntimeError("; ".join(fails))
    init = ref_losses[0]
    losses = {t: _merged_losses(lives[t]) for t in tokens}
    worst = sched_worst = 0.0
    for t in tokens:
        got = losses[t]
        if results[t]["iteration_count"] != steps:
            fails.append(f"{t}: finished at {results[t]['iteration_count']}"
                         f" of {steps} steps")
        for i, r in ref_losses.items():
            if i not in got:
                if t != victim:
                    fails.append(f"{t}: no loss for step {i}")
                continue
            worst = max(worst, abs(got[i] - r))
            if abs(got[i] - r) > DRIFT_BAND * init:
                fails.append(f"{t}: step {i} loss {got[i]} off the "
                             f"reference's {r} by more than "
                             f"{DRIFT_BAND} x {init}")
        for life in lives[t]:
            for i, _ts, g, loss in life["steps"]:
                want = sched.get((g, i))
                rel = (abs(loss - want) / abs(want) if want is not None
                       else np.inf)
                sched_worst = max(sched_worst, rel)
                if rel > LOSS_RTOL:
                    fails.append(f"{t}: generation {g} step {i} loss {loss}"
                                 f" != the scheduled run's {want}")
            if life["device"] is not None and not life["device"].startswith(
                    spec["device"]):
                fails.append(f"{t}: a life trained on {life['device']}, "
                             f"not {spec['device']}")
    hist = {t: _history(lives[t]) for t in tokens}
    gens = sorted({h["generation"] for t in tokens for h in hist[t]})
    widths = {h["generation"]: h["n_workers"] for t in tokens
              for h in hist[t]}
    if killed_at is None or regrown_at is None:
        fails.append(f"the drill did not kill and regrow (killed "
                     f"{killed_at}, regrown {regrown_at})")
    at_done = events.get("generation_at_done")
    if at_done != 3 or len(gens) != 3:
        fails.append(f"expected 3 generations (initial, shrunk, regrown), "
                     f"the coordinator had committed {at_done} when the "
                     f"first worker completed, the workers ran {gens}")
    if tuple(widths.get(g) for g in gens) != WIDTHS:
        fails.append(f"generation widths {widths}, want {WIDTHS}")
    resumed = [h for t in tokens for h in hist[t] if h["generation"] > 1]
    if not resumed or not all(h["resumed"] and h["residual_restored"]
                              for h in resumed):
        fails.append(f"a resume did not restore the residual: {hist}")
    # no step is lost beyond the last checkpoint before the kill
    last_ckpt = KILL_AT // CKPT_FREQUENCY * CKPT_FREQUENCY
    shrunk = [h for h in hist[survivor] if h["n_workers"] == n - 1]
    lost = KILL_AT - (shrunk[0]["step"] if shrunk else 0)
    if not shrunk or shrunk[0]["step"] != last_ckpt:
        fails.append(f"the shrunk generation resumed at "
                     f"{[h['step'] for h in shrunk]}, the last checkpoint "
                     f"before the kill at {KILL_AT} was {last_ckpt}")
    regrow = [h for t in tokens for h in hist[t]
              if h["generation"] == gens[-1]]
    if {h["step"] for h in regrow} != {HOLD_AT}:
        fails.append(f"the regrown generation resumed at "
                     f"{[h['step'] for h in regrow]}, not at the drain "
                     f"step {HOLD_AT}")
    p0 = params[tokens[0]]
    for t in tokens[1:]:
        bad = [k for k in p0 if not np.array_equal(p0[k], params[t][k])]
        if bad:
            fails.append(f"final params differ across workers at {bad[:3]}")
    motion, motion_at = param_motion(p0, refs["scheduled_params"],
                                     refs["init"])
    if motion > PARAM_MOTION_RTOL:
        fails.append(f"final params {motion:.3g} of the scheduled run's "
                     f"motion at {motion_at}")
    pdiff = max(float(np.abs(p0[k] - v).max())
                for k, v in refs["params"].items())
    telemetry = _telemetry(agg, events, tokens, victim, lives, fails)
    try:
        timeline = _timeline(lives, events, survivor, victim, gens,
                             regrown_at)
    except (KeyError, TypeError, ValueError) as e:
        timeline = {}
        fails.append(f"no recovery timeline ({type(e).__name__}: {e})")
    # the committed checkpoints' writer worlds, from their manifests
    from deeplearning4j_tpu_torch.fault import list_checkpoints
    ckpt_dir = os.path.join(os.path.dirname(outs[tokens[0]]), "ckpts")
    manifests = {}
    for step in list_checkpoints(ckpt_dir):
        with open(os.path.join(ckpt_dir, f"ckpt-{step:08d}",
                               "MANIFEST.json")) as f:
            manifests[step] = json.load(f)["process_count"]
    report = dict(
        n_workers=n, device=spec["device"], steps=steps,
        manifest_processes=manifests,
        generations=gens, widths=[widths[g] for g in gens],
        history=hist, reference_losses=[ref_losses[i] for i in
                                        sorted(ref_losses)],
        losses={t: [losses[t].get(i) for i in range(steps)]
                for t in tokens},
        max_loss_drift=worst, initial_loss=init, steps_lost=lost,
        schedule_loss_rel=sched_worst, param_motion=motion,
        param_motion_at=motion_at, final_param_diff=pdiff,
        schedule_drift=max(abs(sched[(g, i)] - ref_losses[i])
                           for g, i in sched),
        reference_device=refs["device"], reference_s=refs["seconds"],
        timeline=timeline, telemetry=telemetry,
        launches=_launches(lives), generation_at_done=at_done,
        coordinator_generations=int(status["generation"]))
    if fails:
        raise DrillFailed("elastic drill: " + "; ".join(fails[:12]), report)
    return report


def _launches(lives):
    """Kernel launches summed over every life of every worker (each
    life's count is its process's, from its start)."""
    out = {}
    for per in lives.values():
        for life in per:
            for k, v in life["launches"].items():
                out[k] = out.get(k, 0) + v
    return out


def _timeline(lives, events, survivor, victim, gens, regrown_at):
    """The shrink's and the regrow's recovery split, ms/step a
    generation, the drain check's host ms a step and the checkpoint's
    write and resume seconds."""
    if len(gens) < 3:
        return {}
    g1, g2, g3 = gens[:3]
    commits = {int(g): t for g, t in events["commits"].items()}
    sl, vl = lives[survivor], lives[victim]
    kill_ts = max(ts for life in vl for it, ts, g, _ in life["steps"]
                  if g == g1)
    gone = [t for t in events["member_gone"].get(victim, []) if t > kill_ts]
    evict = gone[0] if gone else commits[g2]

    def init_end(lv, g):
        # the life that trained in generation g (a relaunched worker may
        # have tried to join an earlier, superseded plan)
        ends = [life["init"][str(g)][1] for life in lv
                if str(g) in life["init"]
                and any(st[2] == g for st in life["steps"])]
        return max(ends) if ends else None

    def first_step(lv, g):
        s = _gen_steps(lv, g)
        return min(ts for _, ts in s) if s else None

    def resume_split(lv, g):
        """The resume's parts in generation g: building the model, the
        trainer and the data; restoring the checkpoint; the first step."""
        life = next(lf for lf in lv if str(g) in lf["resume"]
                    and any(st[2] == g for st in lf["steps"]))
        r0, r1, _ = life["resume"][str(g)]
        return dict(build_s=r0 - life["init"][str(g)][1], restore_s=r1 - r0,
                    first_step_s=first_step(lv, g) - r1)

    s_init2, s_first2 = init_end(sl, g2), first_step(sl, g2)
    shrink = dict(detection_s=evict - kill_ts, settle_s=commits[g2] - evict,
                  reinit_s=s_init2 - commits[g2],
                  resume_s=s_first2 - s_init2,
                  resume_split=resume_split(sl, g2),
                  total_s=s_first2 - kill_ts,
                  survivor_error_s=min((f[0] for life in sl
                                        for f in life["fatal"]),
                                       default=kill_ts) - kill_ts)
    seen = [t for t in events["member_seen"].get(victim, [])
            if t > regrown_at]
    joined = seen[0] if seen else commits[g3]
    v_init3 = init_end(vl, g3)
    s_init3 = init_end(sl, g3)
    grow = dict(detection_s=joined - regrown_at, settle_s=commits[g3] - joined,
                reinit_s=max(v_init3, s_init3) - commits[g3],
                resume_s=first_step(sl, g3) - max(v_init3, s_init3),
                resume_split=resume_split(vl, g3),
                total_s=first_step(sl, g3) - regrown_at)
    ms = {}
    for g in (g1, g2, g3):
        s = sorted(_gen_steps(sl, g))
        gaps = [(b[1] - a[1]) * 1e3 for a, b in zip(s, s[1:])
                if b[0] == a[0] + 1]
        ms[str(g)] = dict(first_step_s=(s[0][1] - init_end(sl, g))
                          if s and init_end(sl, g) else None,
                          ms_per_step=float(np.mean(gaps)) if gaps else None,
                          gaps_ms=[round(x, 2) for x in gaps], steps=len(s))
    drains = [st for life in sl + vl for st in life["drain"].values()
              if st["calls"]]
    drain_ms = (1e3 * sum(d["seconds"] for d in drains)
                / max(1, sum(d["calls"] for d in drains)))
    writes = [life["ckpt"] for life in sl + vl
              if life["ckpt"].get("count")]
    n_w = sum(w["count"] for w in writes)
    resumes = [r[1] - r[0] for life in sl + vl for r in
               life["resume"].values() if r[2]]
    starts = {t: [[round(life["started"], 3), round(life.get(
        "fit_at", life["started"]), 3)] for life in lv]
        for t, lv in ((survivor, sl), (victim, vl))}
    return dict(shrink=shrink, regrow=grow, ms_per_step=ms,
                lives=starts, kill_ts=kill_ts, commits=commits,
                drain_check_host_ms=drain_ms, ckpt_writes=n_w,
                ckpt_write_s=(sum(w["seconds"] for w in writes) / n_w
                              if n_w else None),
                ckpt_mb=(sum(w["bytes"] for w in writes) / n_w / 1e6
                         if n_w else None),
                resume_s=resumes)


def _telemetry(agg, events, tokens, victim, lives, fails):
    """What the federated view and the alert engine showed."""
    alerts = events["alerts"]
    shrink = [e["state"] for e in alerts if e.get("alert") == "elastic-shrink"]
    if "firing" not in shrink or shrink[-1] != "resolved":
        fails.append(f"elastic-shrink went {shrink}, not firing then "
                     f"resolved")
    ages = events["export_age_max"]
    if ages.get(victim, 0.0) <= WORKER_STALE_S:
        fails.append(f"{victim}'s federated series never went stale "
                     f"(oldest {ages.get(victim)} s)")
    if "victim_returned" not in events:
        fails.append(f"{victim}'s federated series did not return after "
                     f"the regrow")
    snap = agg.snapshot()

    def merged(name):
        vals = snap.get(name, {}).get("values", [])
        return float(sum(v.get("value", 0.0) for v in vals))

    per = {}
    for line in agg.exposition().splitlines():
        for fam in ("elastic_drains_total", "elastic_resume_total",
                    "elastic_generation"):
            if line.startswith(fam + "{worker="):
                w = line.split('"')[1]
                per.setdefault(fam, {})[w] = float(line.split()[-1])
    if not set(tokens) <= set(agg.workers()):
        fails.append(f"federated workers {agg.workers()} miss {tokens}")
    # each worker's last life: a generation it left before its last
    # ended in a drain or in a broken world, and each generation after
    # its first resumed
    want_drains = want_resumes = 0
    for t in tokens:
        last = lives[t][-1]
        want_drains += max(0, len(last["history"]) - 1 - len(last["fatal"]))
        want_resumes += sum(1 for h in last["history"] if h["resumed"])
    got = (merged("elastic_drains_total"), merged("elastic_resume_total"))
    if got != (want_drains, want_resumes):
        fails.append(f"federated elastic_drains_total, elastic_resume_total "
                     f"read {got}, the workers' histories say "
                     f"{(want_drains, want_resumes)}")
    vanished = [e["state"] for e in alerts
                if e.get("alert") == "worker-vanished"]
    return dict(elastic_shrink=shrink, worker_vanished=vanished,
                export_age_max_s=ages,
                victim_returned_after_s=(events.get("victim_returned", 0.0)
                                         - events.get("regrown_at", 0.0)),
                elastic_generation=snap.get("elastic_generation", {}).get(
                    "values", []),
                elastic_drains_total=merged("elastic_drains_total"),
                elastic_resume_total=merged("elastic_resume_total"),
                elastic_reconfigurations_total=merged(
                    "elastic_reconfigurations_total"),
                by_worker=per, workers=agg.workers())


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--child"]:
        spec, token, control, ckpt_dir, out, kill_at = argv[1:7]
        _child_main(json.loads(spec), token, control, ckpt_dir, out,
                    int(kill_at))
        return 0
    device = "cuda"
    if "--device" in argv:
        device = argv[argv.index("--device") + 1]
    report = run_drill(device=device)
    print(json.dumps({k: v for k, v in report.items()
                      if k not in ("history",)}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
