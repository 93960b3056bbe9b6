"""Run port scenarios in several processes for the tests.

`spawn(scenario, n, **args)` starts n processes of this file, each
`initialize_multihost` on the CPU (gloo) with two mesh devices, runs
`SCENARIOS[scenario](args)` and prints its result as one JSON line; the
parent returns [result of rank 0, ..., rank n-1]. Each worker runs
with one intra-op thread and a wall timeout; a worker that fails kills
its siblings. `spawn_results` returns every rank's exit code and result
instead, for a scenario in which a worker dies by design. The same
scenario functions run in one process (on a mesh of the same shape) as
the reference.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TIMEOUT = 240.0
LOCAL = 2


# ------------------------------------------------------------- models
def bn_dropout_mlp(lr=0.05, seed=7, dropout=0.8, updater="sgd"):
    """Dense(dropout) -> BatchNorm -> Dense -> Output (the data-parallel
    tests' net, `test_torch_port_parallel_trainer.bn_dropout_conf`), built with the port's builder on the CPU."""
    from deeplearning4j_tpu_torch.common.updaters import Adam, Sgd
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import (
        BatchNormalization, DenseLayer, OutputLayer)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    up = Sgd(lr) if updater == "sgd" else Adam(lr)
    conf = (NeuralNetConfiguration.builder().seed(seed).updater(up).list()
            .layer(DenseLayer(n_in=16, n_out=16, activation="tanh",
                              dropout=dropout))
            .layer(BatchNormalization(n_out=16))
            .layer(DenseLayer(n_in=16, n_out=16, activation="tanh"))
            .layer(OutputLayer(n_in=16, n_out=4, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(16)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def data(n=16, seed=3):
    import numpy as np
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 16)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]
    return x, y


def table(net):
    return {k: v.detach().cpu().numpy().tolist()
            for k, v in net.param_table().items()}


def updater_table(net):
    out = {}
    for lk, lst in net.updater_state.items():
        for pk, st in lst.items():
            for sk, t in st.items():
                out[f"{lk}/{pk}/{sk}"] = t.detach().cpu().numpy().tolist()
    return out


MODES = {"dense_global": dict(gradient_sharing="dense", bucketed=False),
         "dense": dict(gradient_sharing="dense"),
         "threshold": dict(gradient_sharing="threshold"),
         "threshold_single": dict(gradient_sharing="threshold",
                                  bucketed=False),
         "dense_rs": dict(gradient_sharing="dense_rs"),
         "threshold_rs": dict(gradient_sharing="threshold_rs"),
         "averaging": dict(mode="averaging", averaging_frequency=2)}


def _mesh(spec, devices):
    from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    return make_mesh(MeshSpec.of(**spec), devices=devices)


def _fit_losses(trainer, x, y, steps, B):
    from deeplearning4j_tpu_torch.optimize.listeners import (
        CollectScoresListener)
    scores = CollectScoresListener()
    trainer.model.set_listeners(scores)
    for s in range(steps):
        trainer.fit(x[s * B:(s + 1) * B], y[s * B:(s + 1) * B],
                    batch_size=B)
    trainer.model.set_listeners()
    return [v for _, v in scores.scores]


# ------------------------------------------------------------ scenarios
def scenario_trainers(args, devices=None):
    """Every ParallelTrainer mode, the sharded trainer (TP with the model
    axis outermost, FSDP) and the residual's full view on the global
    4-device mesh."""
    from deeplearning4j_tpu_torch.parallel.tensor import (
        ShardedParallelTrainer, fsdp_param_specs)
    from deeplearning4j_tpu_torch.parallel.trainer import ParallelTrainer
    B, steps = 16, 3
    x, y = data(B * steps)
    out = {}
    for name, kw in MODES.items():
        net = bn_dropout_mlp(updater="adam" if "rs" in name else "sgd",
                             lr=1e-2 if "rs" in name else 0.05)
        tr = ParallelTrainer(net, _mesh({"data": 4}, devices), **kw)
        losses = _fit_losses(tr, x, y, steps, B)
        res = tr.threshold_residual() if "threshold" in name else None
        out[name] = dict(losses=losses, params=table(net),
                         updater=updater_table(net),
                         residual_rows=(None if res is None else int(
                             next(iter(next(iter(res.values())).values()))
                             .shape[0])))
    for name, spec in (("tp", {"model": 2, "data": 2}),
                       ("fsdp", {"data": 4})):
        net = bn_dropout_mlp(updater="adam", lr=1e-2)
        mesh = _mesh(spec, devices)
        specs = (fsdp_param_specs(net, "data", axis_size=4,
                                  min_shard_elems=16)
                 if name == "fsdp" else None)
        tr = ShardedParallelTrainer(net, mesh, param_specs=specs)
        losses = _fit_losses(tr, x, y, steps, B)
        out[name] = dict(losses=losses, params=table(net),
                         updater=updater_table(net),
                         state=[float(v) for v in
                                net.net_state["1"]["mean"].tolist()])
    return out


def scenario_checkpoint(args, devices=None):
    """A threshold run checkpointed behind the barrier at step 2 and
    stopped at 3 in `args["dir"]`, resumed by a new trainer and trained
    to 4; against the uninterrupted run. Then a ShardedCheckpoint of a
    TP trainer's state in `args["dir"]/sharded`."""
    import numpy as np

    from deeplearning4j_tpu_torch import fault
    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.parallel.tensor import (
        ShardedParallelTrainer)
    from deeplearning4j_tpu_torch.parallel.trainer import ParallelTrainer
    from deeplearning4j_tpu_torch.util.sharded_checkpoint import (
        ShardedCheckpoint)
    B = 16
    x, y = data(B * 4, seed=5)
    batches = [DataSet(x[i:i + B], y[i:i + B]) for i in range(0, 4 * B, B)]
    kw = dict(gradient_sharing="threshold")
    mesh = _mesh({"data": 4}, devices)
    ref = bn_dropout_mlp(updater="adam", lr=1e-2)
    ParallelTrainer(ref, mesh, **kw).fit(ListDataSetIterator(batches))
    d = args["dir"]
    net = bn_dropout_mlp(updater="adam", lr=1e-2)
    ck = fault.AsyncCheckpointer(d)
    net.set_listeners(fault.CheckpointListener(ck, frequency=2),
                      fault.PreemptionListener(3, wait_for_checkpointer=ck))
    t0 = time.perf_counter()
    try:
        ParallelTrainer(net, mesh, **kw).fit(ListDataSetIterator(batches))
    except fault.SimulatedPreemption:
        pass
    ck.wait()
    write_s = time.perf_counter() - t0
    from deeplearning4j_tpu_torch.parallel import multihost
    if multihost.process_count() > 1:
        import torch.distributed as dist
        dist.barrier()
    back = bn_dropout_mlp(updater="adam", lr=1e-2)
    t = ParallelTrainer(back, mesh, **kw)
    t.resume(d)
    at = back.iteration_count
    t.fit(ListDataSetIterator(batches[2:]))
    same = (table(back) == table(ref)
            and updater_table(back) == updater_table(ref))
    # the sharded checkpoint of a TP trainer's state
    tp = bn_dropout_mlp(updater="adam", lr=1e-2, dropout=None)
    tr = ShardedParallelTrainer(tp, _mesh({"model": 2, "data": 2}, devices))
    tr.fit(x[:B], y[:B], batch_size=B)
    sdir = os.path.join(os.path.dirname(d), "sharded")
    ShardedCheckpoint.save(sdir, tp, trainer=tr)
    out = np.asarray(tp.output(x)).tolist()
    restored = ShardedCheckpoint.restore(sdir, device="cpu")
    return dict(resumed_at=at, bit_equal=same, write_s=write_s,
                params=table(back), output=out,
                restored_output=np.asarray(restored.output(x)).tolist())


def scenario_elastic_world(args, devices=None):
    """The elastic runtime's world seams in 2 processes: `device_mesh()`
    spans both processes' CPU devices, the drain check ORs the flags
    across them; then rank 1 SIGKILLs itself and rank 0 classifies the
    broken collective, tears the world down (bounded) and brings up a
    world of its own at another port, with another mesh."""
    import signal

    import torch
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel import collectives, multihost
    from deeplearning4j_tpu_torch.parallel.elastic import (
        distributed_failure, make_drain_check)
    from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, device_mesh
    rank = multihost.process_index()
    mesh = device_mesh()
    check = make_drain_check(mesh)
    out = dict(mesh=dict(mesh.shape), spec=MeshSpec.data_parallel().shape(),
               mesh_ranks=[int(r) for r in mesh.ranks.flat],
               drain=[check(rank == 0), check(False), check(True)],
               drain_calls=check.stats["calls"])
    t = torch.ones(2)
    dist.all_reduce(t)
    if rank == 1:
        os.kill(os.getpid(), signal.SIGKILL)
    time.sleep(0.5)
    try:
        dist.all_reduce(t)
        out["error"] = None
    except Exception as e:  # noqa: BLE001 — the case under test
        out["error"] = f"{type(e).__name__}: {str(e)[:200]}"
        out["fatal"] = distributed_failure(e)
    t0 = time.perf_counter()
    multihost.shutdown_multihost()
    out["teardown_s"] = time.perf_counter() - t0
    out["groups_left"] = len(collectives._GROUPS)
    out["active_after_teardown"] = multihost.multihost_active()
    multihost.initialize_multihost(args["second"], 1, 0,
                                   devices=["cpu"] * 3,
                                   initialization_timeout=60)
    t = torch.ones(2)
    dist.all_reduce(t)
    m2 = device_mesh()
    out.update(second_world=dist.get_world_size(), second_sum=t.tolist(),
               second_mesh=dict(m2.shape),
               second_drain=make_drain_check(m2)(True))
    return out


SCENARIOS = {"trainers": scenario_trainers,
             "checkpoint": scenario_checkpoint,
             "elastic_world": scenario_elastic_world}


def single(scenario, **args):
    """The scenario in this process on a 4-device CPU mesh."""
    return SCENARIOS[scenario](args, devices=["cpu"] * (2 * LOCAL))


# ------------------------------------------------------------- spawning
def _free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _start(scenario, n, args):
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=ROOT + (os.pathsep + os.environ["PYTHONPATH"]
                                  if os.environ.get("PYTHONPATH") else ""))
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), scenario, str(r),
         str(n), coord, json.dumps(args)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=ROOT) for r in range(n)]


def _result(out):
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):]) if line else None


def spawn(scenario, n=2, **args):
    """[rank r's result] of `scenario` in n processes; a worker that
    fails kills its siblings."""
    from deeplearning4j_tpu_torch.parallel.multihost_smoke import _wait_all
    results, timed_out = _wait_all(_start(scenario, n, args), TIMEOUT)
    outs = []
    for rc, out, err in results:
        if rc != 0:
            raise RuntimeError(f"worker failed rc={rc}"
                               f"{' (timed out)' if timed_out else ''}: "
                               f"{err[-3000:]}")
        outs.append(_result(out))
    return outs


def spawn_results(scenario, n=2, **args):
    """[(rc, result or None, stderr) of rank r] of `scenario` in n
    processes, where a worker may die by design (its siblings run on,
    all within the wall timeout)."""
    procs = _start(scenario, n, args)
    deadline = time.time() + TIMEOUT
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, err = p.communicate()
            err += "\n(timed out)"
        outs.append((p.returncode, _result(out), err))
    return outs


def _worker(scenario, rank, n, coord, args):
    import torch
    torch.set_num_threads(1)
    from deeplearning4j_tpu_torch.parallel import multihost
    multihost.initialize_multihost(coord, n, rank, devices=["cpu"] * LOCAL,
                                   initialization_timeout=TIMEOUT)
    try:
        res = SCENARIOS[scenario](args)
        print("RESULT " + json.dumps(res), flush=True)
    finally:
        multihost.shutdown_multihost()


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
            json.loads(sys.argv[5]))
