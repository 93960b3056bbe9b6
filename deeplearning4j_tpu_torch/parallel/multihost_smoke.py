"""Multi-process distributed-training smoke proof (counterpart of
`deeplearning4j_tpu/parallel/multihost_smoke.py`).

N worker processes bring up one world (`initialize_multihost`), each
owning two mesh devices, and run the same global-view training as one
single-process reference on a mesh of the same shape: JAX's MLP trained
dense (`ParallelTrainer`), then DP x TP (`ShardedParallelTrainer` with
the "model" axis outermost, so the model-axis shards straddle the
process boundary and every gather crosses processes), then with the
threshold exchange. Each worker also scores its own rows of the data
and sends the `Evaluation` as JSON; the merged evaluation is compared
with the single process's.

Usage:

    python -m deeplearning4j_tpu_torch.parallel.multihost_smoke --n 2 \\
        --device cpu

Checks (JAX's): every trajectory within 1e-4 x max(1, |loss|) of the
single process's, the merged evaluation's totals equal and its
confusion matrix within an L1 of 2, and the dense loss learning. On
CUDA devices the workers use NCCL, one card each, unless `backend`
names gloo (the one-card case: both workers on card 0, each exchange
staged through host memory). Every worker runs with one intra-op
thread; a worker that dies takes its siblings down with it.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

_LOCAL_DEVICES = 2   # mesh devices per process


def _build_model(device):
    from deeplearning4j_tpu_torch.common.updaters import Adam
    from deeplearning4j_tpu_torch.common.weights import WeightInit
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (NeuralNetConfiguration.builder()
            .seed(21).updater(Adam(5e-2)).weight_init(WeightInit.XAVIER)
            .list()
            .layer(DenseLayer(n_in=6, n_out=16, activation="tanh"))
            .layer(OutputLayer(n_in=16, n_out=3, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(6))
            .build())
    return MultiLayerNetwork(conf, device=device).init()


def _run_training(device, devices=None):
    """Dense DP, DP x TP and threshold training on the global mesh (the
    world's devices, or `devices` in one process); returns (losses of
    the dense and TP phases, threshold losses, this process's
    Evaluation of its rows as JSON)."""
    import numpy as np

    from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
    from deeplearning4j_tpu_torch.optimize.listeners import (
        CollectScoresListener)
    from deeplearning4j_tpu_torch.parallel import multihost
    from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from deeplearning4j_tpu_torch.parallel.tensor import (
        ShardedParallelTrainer)
    from deeplearning4j_tpu_torch.parallel.trainer import ParallelTrainer

    n_dev = (len(multihost.global_devices()) if devices is None
             else len(devices))
    mesh = make_mesh(MeshSpec.of(data=n_dev), devices=devices)
    rng = np.random.default_rng(0)
    B = 16
    x = rng.standard_normal((B, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, B)]

    model = _build_model(device)
    listener = CollectScoresListener()
    model.set_listeners(listener)
    ParallelTrainer(model, mesh, mode="sync").fit(x, y, epochs=5,
                                                  batch_size=B)
    losses = [s for _, s in listener.scores]

    # "model" outermost: the global device list is process-major and
    # the mesh row-major, so the model-axis shards sit in different
    # processes and every gather of them crosses processes
    tp_mesh = make_mesh(MeshSpec.of(model=2, data=max(n_dev // 2, 1)),
                        devices=devices)
    tp_model = _build_model(device)
    tp_listener = CollectScoresListener()
    tp_model.set_listeners(tp_listener)
    tp_trainer = ShardedParallelTrainer(tp_model, tp_mesh)
    tp_trainer.fit(x, y, epochs=2, batch_size=B)
    tp_trainer.fit(x, y, epochs=1, batch_size=B)

    thr_model = _build_model(device)
    thr_listener = CollectScoresListener()
    thr_model.set_listeners(thr_listener)
    ParallelTrainer(thr_model, mesh, mode="sync",
                    gradient_sharing="threshold").fit(x, y, epochs=3,
                                                      batch_size=B)
    thr_losses = [s for _, s in thr_listener.scores]

    # each process scores its own rows; the evaluators travel as JSON
    pi, pc = multihost.process_index(), multihost.process_count()
    bounds = np.cumsum([0] + [len(a) for a in np.array_split(x, pc)])
    shard = slice(int(bounds[pi]), int(bounds[pi + 1]))
    local_ev = Evaluation()
    local_ev.eval(y[shard], model.output(x[shard]).float().cpu().numpy())
    return (losses + [s for _, s in tp_listener.scores], thr_losses,
            local_ev.to_json())


def _cap_threads():
    import torch
    torch.set_num_threads(1)


def _worker_devices(device: str, i: int):
    if device == "cpu":
        return ["cpu"] * _LOCAL_DEVICES
    import torch
    n = max(1, torch.cuda.device_count())
    return [f"cuda:{i % n}"] * _LOCAL_DEVICES


def _worker_main(coordinator: str, n: int, i: int, device: str,
                 backend, timeout: float):
    _cap_threads()
    from deeplearning4j_tpu_torch.parallel import multihost
    devs = _worker_devices(device, i)
    multihost.initialize_multihost(coordinator, n, i, devices=devs,
                                   backend=backend,
                                   initialization_timeout=timeout)
    try:
        assert multihost.process_count() == n, multihost.process_count()
        assert len(multihost.global_devices()) == n * _LOCAL_DEVICES
        print("BACKEND " + multihost.backend(), flush=True)
        losses, thr_losses, eval_json = _run_training(devs[0])
        print("LOSSES " + json.dumps(losses), flush=True)
        print("THRLOSSES " + json.dumps(thr_losses), flush=True)
        print("EVALJSON " + eval_json, flush=True)
    finally:
        multihost.shutdown_multihost()


def _single_main(n: int, device: str):
    _cap_threads()
    dev = "cpu" if device == "cpu" else "cuda:0"
    losses, thr_losses, eval_json = _run_training(
        dev, devices=[dev] * (n * _LOCAL_DEVICES))
    print("LOSSES " + json.dumps(losses), flush=True)
    print("THRLOSSES " + json.dumps(thr_losses), flush=True)
    print("EVALJSON " + eval_json, flush=True)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(args):
    env = dict(os.environ)
    # a spawned worker inherits no thread cap: one OpenMP thread each
    env["OMP_NUM_THREADS"] = "1"
    env["MKL_NUM_THREADS"] = "1"
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    return subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.parallel."
         "multihost_smoke", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=root)


def _parse_tag(out: str, tag: str):
    for line in out.splitlines():
        if line.startswith(tag + " "):
            return line[len(tag) + 1:]
    return None


class _PortBindRace(RuntimeError):
    """The rendezvous lost the race for its pre-probed port (another job
    took it between `_free_port` and the bind)."""


_BIND_MARKERS = ("Address already in use", "address already in use",
                 "EADDRINUSE", "Failed to bind")


def _wait_all(procs, timeout: float):
    """Wait for every process; the first to fail (or the deadline)
    kills the rest. Returns [(rc, out, err)] in order."""
    import threading
    outs = [None] * len(procs)

    def drain(k, p):
        outs[k] = p.communicate()

    threads = [threading.Thread(target=drain, args=(k, p), daemon=True)
               for k, p in enumerate(procs)]
    for t in threads:
        t.start()
    deadline = time.time() + timeout
    failed = False
    while any(t.is_alive() for t in threads):
        if time.time() > deadline:
            failed = True
        if any(p.poll() not in (None, 0) for p in procs):
            failed = True
        if failed:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for t in threads:
            t.join(timeout=0.05)
    return [(p.returncode, *(outs[k] or ("", ""))) for k, p in
            enumerate(procs)], time.time() > deadline


def run_smoke(n: int = 2, *, device: str = "cuda", timeout: float = 420,
              bind_attempts: int = 3, backend=None) -> dict:
    """n distributed workers and one single-process reference, their
    trajectories and evaluations compared (JAX's checks). Returns a
    report; raises on a failure. A lost race for the rendezvous port
    retries the whole cycle on a fresh port, `bind_attempts` times."""
    from deeplearning4j_tpu_torch.device import resolve_device
    resolve_device(device)
    last: Exception = RuntimeError("unreachable")
    for attempt in range(max(1, int(bind_attempts))):
        try:
            return _run_smoke_once(n, device, timeout, backend)
        except _PortBindRace as e:
            last = e
            import logging
            logging.getLogger(__name__).warning(
                "rendezvous port bind race (attempt %d/%d): %s — "
                "retrying on a fresh port", attempt + 1, bind_attempts,
                str(e)[-200:])
    raise last


def _run_smoke_once(n: int, device: str, timeout: float, backend) -> dict:
    coord = f"127.0.0.1:{_free_port()}"
    t0 = time.time()
    extra = ["--device", device, "--timeout", str(timeout)] + (
        ["--backend", backend] if backend else [])
    procs = [_spawn(["--worker", str(i), "--n", str(n), "--coordinator",
                     coord] + extra) for i in range(n)]
    procs.append(_spawn(["--single", "--n", str(n)] + extra))
    try:
        results, timed_out = _wait_all(procs, timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    *workers, (src, sout, serr) = results
    for rc, out, err in workers:
        if rc != 0:
            if any(m in err for m in _BIND_MARKERS):
                raise _PortBindRace(err[-400:])
            raise RuntimeError(f"worker failed rc={rc}"
                               f"{' (timed out)' if timed_out else ''}: "
                               f"{err[-1500:]}")
    if src != 0:
        raise RuntimeError(f"single-proc run failed: {serr[-1500:]}")

    def losses_of(out, tag):
        s = _parse_tag(out, tag)
        return None if s is None else json.loads(s)

    ref, thr_ref = losses_of(sout, "LOSSES"), losses_of(sout, "THRLOSSES")
    results = [losses_of(o, "LOSSES") for _, o, _ in workers]
    thr_results = [losses_of(o, "THRLOSSES") for _, o, _ in workers]
    if any(r is None for r in results) or ref is None:
        raise RuntimeError("missing LOSSES output")

    def check_match(worker_traj, ref_traj, what):
        for i, r in enumerate(worker_traj):
            if r is None or ref_traj is None or len(r) != len(ref_traj):
                raise RuntimeError(
                    f"worker {i} {what} trajectory length mismatch: "
                    f"{r} vs {ref_traj}")
            for a, b in zip(r, ref_traj):
                if abs(a - b) > 1e-4 * max(1.0, abs(b)):
                    raise RuntimeError(
                        f"worker {i} {what} loss diverged from single-"
                        f"process run: {r} vs {ref_traj}")

    check_match(results, ref, "dense")
    check_match(thr_results, thr_ref, "threshold")
    if not ref[4] < ref[0]:
        raise RuntimeError(f"the dense loss did not fall: {ref[:5]}")
    import numpy as np

    from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
    evals = [_parse_tag(o, "EVALJSON") for _, o, _ in workers]
    ref_eval = _parse_tag(sout, "EVALJSON")
    if any(e is None for e in evals) or ref_eval is None:
        raise RuntimeError("missing EVALJSON output")
    merged = Evaluation()
    for e in evals:
        merged.merge(Evaluation.from_json(e))
    ref_ev = Evaluation.from_json(ref_eval)
    # the loss check tolerates 1e-4 of drift (reduction order), so one
    # argmax near-tie may flip one sample's class between the runs
    diff = int(np.abs(np.asarray(merged.confusion.matrix)
                      - np.asarray(ref_ev.confusion.matrix)).sum())
    if not (merged.total == ref_ev.total and diff <= 2):
        raise RuntimeError(
            f"merged distributed evaluation != single-process "
            f"(L1 diff {diff}): {np.asarray(merged.confusion.matrix)} vs "
            f"{np.asarray(ref_ev.confusion.matrix)}")
    return {"n_processes": n, "device": device,
            "backend": _parse_tag(workers[0][1], "BACKEND"),
            "losses": results[0], "single_process": ref,
            "threshold_losses": thr_results[0], "match": True,
            "threshold_match": True, "eval_merge_match": True,
            "eval_l1_diff": diff, "seconds": time.time() - t0}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    args = {argv[i]: argv[i + 1] if i + 1 < len(argv) else None
            for i in range(len(argv)) if argv[i].startswith("--")}
    device = args.get("--device") or "cuda"
    timeout = float(args.get("--timeout") or 420)
    if "--worker" in args:
        _worker_main(args["--coordinator"], int(args["--n"]),
                     int(args["--worker"]), device, args.get("--backend"),
                     timeout)
    elif "--single" in args:
        _single_main(int(args.get("--n") or 2), device)
    else:
        report = run_smoke(int(args.get("--n") or 2), device=device,
                           timeout=timeout, backend=args.get("--backend"))
        print(json.dumps(report))


if __name__ == "__main__":
    main()
