"""Fault-injection drill on the port: real subprocess kills, auto-resume,
bit-parity verdict (counterpart of `scripts/fault_drill.py`).

    python -m deeplearning4j_tpu_torch.scripts.fault_drill --smoke \
        [--with-corruption] [--device cuda|cpu]

1. reference: a child process trains a tiny MLP for 30 steps
   (3 epochs x 10 shuffled batches) with NO fault machinery and dumps
   its final params + updater state;
2. drill: a second lineage trains the same run with an
   AsyncCheckpointer (freq 5, keep-last 3) and a scripted SIGTERM at
   step 15 — the process dies for real (the atomic tmp + fsync + rename
   commit is what keeps the checkpoint directory sane through that).
   With --with-corruption the newest committed checkpoint is then
   bit-flipped, drilling the fallback to the one before;
3. auto-resume: the child is relaunched with --resume until it
   completes (each resume restores model, counters and the iterator's
   cursor from the newest VALID checkpoint);
4. verdict: the resumed lineage's final params and updater state must
   be BIT-IDENTICAL to the uninterrupted reference — exit 0 iff so.

The dumps carry JAX's npz keys (`params<US>layer<US>name`,
`updater<US>...`, `__counters__`), so either package's `_compare` reads
the other's. The MLP (4 -> 16 -> 3) has no packed run: its Adam is per
leaf, and the drill launches no hand-written kernel. The last line of
`--smoke` is one JSON object: the verdict, the restarts and the seconds
from the kill to the resumed lineage's first step.

`--elastic-smoke` runs the elastic membership drill
(`parallel/elastic_smoke.py`); `--elastic-child` and `--elastic-ref`
are its worker and its uninterrupted reference. `--child` is this
drill's worker.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.scripts import _common

MODULE = "deeplearning4j_tpu_torch.scripts.fault_drill"

# the deterministic tiny-MLP problem every child process shares
SEED = 7
N_FEATURES, N_HIDDEN, N_CLASSES = 4, 16, 3
N_EXAMPLES, BATCH = 80, 8          # 10 batches an epoch
EPOCHS = 3                          # 30 steps in all
KILL_AT = 15
MAX_RESTARTS = 4
CHILD_TIMEOUT_S = 300


def _build_net(device):
    from deeplearning4j_tpu_torch.common.updaters import Adam
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (NeuralNetConfiguration.builder().seed(SEED)
            .updater(Adam(0.01)).list()
            .layer(DenseLayer(n_in=N_FEATURES, n_out=N_HIDDEN,
                              activation="tanh"))
            .layer(OutputLayer(n_in=N_HIDDEN, n_out=N_CLASSES,
                               activation="softmax", loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf, device=device)


def _make_iterator():
    import numpy as np
    from deeplearning4j_tpu_torch.datasets.iterator import (
        ArrayDataSetIterator)

    rng = np.random.default_rng(0)
    x = rng.standard_normal((N_EXAMPLES, N_FEATURES)).astype(np.float32)
    w = rng.standard_normal((N_FEATURES, N_CLASSES))
    y = np.eye(N_CLASSES, dtype=np.float32)[np.argmax(x @ w, axis=1)]
    # shuffle=True on purpose: the drill proves that the cursor replays
    # the interrupted epoch's exact permutation
    return ArrayDataSetIterator(x, y, batch_size=BATCH, shuffle=True,
                                seed=11)


def _dump_final(net, out_path):
    """Final params, updater state and counters under JAX's npz keys."""
    import numpy as np
    from deeplearning4j_tpu_torch.fault import state as fs

    arrays = fs.model_arrays(net)
    flat = {}
    flat.update({f"params{fs.SEP}{k}": v for k, v in
                 fs.flatten_arrays(arrays["params"]).items()})
    flat.update({f"updater{fs.SEP}{k}": v for k, v in
                 fs.flatten_arrays(arrays["updater_state"]).items()})
    flat["__counters__"] = np.asarray(
        [net.iteration_count, net.epoch_count])
    with open(out_path, "wb") as f:
        np.savez(f, **flat)


class _FirstStepStamp(TrainingListener):
    """Writes the wall-clock time of the lineage's first completed step
    to `path` (the drill's kill-to-resume measurement)."""

    def __init__(self, path):
        self.path = path
        self.done = False

    def iteration_done(self, model, iteration, epoch, score, **info):
        if self.done:
            return
        self.done = True
        _common.sync(model.device)
        with open(self.path, "w") as f:
            f.write(repr(time.time()))


def run_child(args) -> int:
    from deeplearning4j_tpu_torch import fault

    device = resolve_device(args.device)
    iterator = _make_iterator()
    if args.resume:
        try:
            net, _ = fault.resume(args.ckpt_dir, iterator=iterator,
                                  device=device)
        except FileNotFoundError:
            # preempted before the first commit landed: a cold restart
            # replays from step 0, which reproduces the run exactly too
            print("no committed checkpoint yet; cold restart")
            net = _build_net(device).init()
    else:
        net = _build_net(device).init()
    if args.stamp:
        net.add_listener(_FirstStepStamp(args.stamp))
    ckptr = None
    if args.ckpt_dir:
        ckptr = fault.AsyncCheckpointer(args.ckpt_dir, keep_last=3)
        net.add_listener(fault.CheckpointListener(
            ckptr, frequency=args.ckpt_freq, iterator=iterator))
    if args.kill_at:
        # a preemption arrives with a notice: the SIGTERM drains the
        # pending checkpoint writes first (the torn-write path is what
        # the atomic commit and the corruption drill cover)
        net.add_listener(fault.PreemptionListener(
            args.kill_at, mode="sigterm", wait_for_checkpointer=ckptr))
    net.fit(iterator, epochs=EPOCHS - net.epoch_count)
    _dump_final(net, args.out)
    print(f"child done: {net.iteration_count} steps, "
          f"{net.epoch_count} epochs")
    return 0


def _spawn(out, device, ckpt_dir=None, kill_at=None, resume=False,
           ckpt_freq=5, stamp=None) -> int:
    argv = ["--child", "--out", out, "--ckpt-freq", ckpt_freq,
            "--device", device]
    if ckpt_dir:
        argv += ["--ckpt-dir", ckpt_dir]
    if kill_at:
        argv += ["--kill-at", kill_at]
    if resume:
        argv += ["--resume"]
    if stamp:
        argv += ["--stamp", stamp]
    proc = subprocess.run([sys.executable, "-m", MODULE, *map(str, argv)],
                          env=_common.child_env(),
                          cwd=str(_common.REPO_ROOT),
                          timeout=CHILD_TIMEOUT_S)
    return proc.returncode


def _compare(ref_path, got_path) -> list:
    import numpy as np

    with np.load(ref_path) as a, np.load(got_path) as b:
        bad = []
        for k in sorted(set(a.files) | set(b.files)):
            if k not in a.files or k not in b.files:
                bad.append(f"{k}: missing on one side")
            elif a[k].dtype != b[k].dtype or a[k].shape != b[k].shape \
                    or not np.array_equal(a[k], b[k]):
                bad.append(f"{k}: differs")
        return bad


def smoke(with_corruption: bool, device: str = "cuda",
          work_dir=None) -> dict:
    """The kill-and-resume drill. Returns its report: `ok`, the
    restarts, `kill_to_resume_s` (from the killed child's exit, seen by
    this process, to the resumed lineage's first completed step) and
    the first differences when the verdict fails."""
    resolve_device(device)
    own_dir = work_dir is None
    tmp = work_dir or tempfile.mkdtemp(prefix="fault_drill_")
    ref_out = os.path.join(tmp, "reference.npz")
    got_out = os.path.join(tmp, "resumed.npz")
    ckpt_dir = os.path.join(tmp, "ckpts")
    stamp = os.path.join(tmp, "first_step")
    report = {"ok": False, "device": _common.card_label(device),
              "with_corruption": bool(with_corruption), "work_dir": tmp}

    print(f"== fault drill: uninterrupted reference ({EPOCHS * 10} "
          f"steps) ==", flush=True)
    t0 = time.perf_counter()
    rc = _spawn(ref_out, device)
    report["reference_s"] = time.perf_counter() - t0
    if rc != 0:
        report["error"] = f"reference run exited {rc}"
        return report

    print(f"== fault drill: SIGTERM at step {KILL_AT}, checkpoint every "
          f"5 ==", flush=True)
    rc = _spawn(got_out, device, ckpt_dir=ckpt_dir, kill_at=KILL_AT)
    t_kill = time.time()
    report["killed_rc"] = rc
    if rc == 0:
        report["error"] = "scripted kill did not fire"
        return report
    print(f"child died as scripted (rc={rc})", flush=True)
    from deeplearning4j_tpu_torch import fault
    report["committed_at_kill"] = fault.list_checkpoints(ckpt_dir)

    if with_corruption:
        path = fault.corrupt_checkpoint(ckpt_dir, mode="flip")
        report["corrupted"] = str(path)
        print(f"injected bit-flip into {path} — resume must fall back",
              flush=True)

    restarts = 0
    while restarts < MAX_RESTARTS:
        print(f"== fault drill: auto-resume attempt {restarts + 1} ==",
              flush=True)
        rc = _spawn(got_out, device, ckpt_dir=ckpt_dir, resume=True,
                    stamp=stamp if restarts == 0 else None)
        if rc == 0:
            break
        restarts += 1
    else:
        report["error"] = (f"resume did not complete within "
                           f"{MAX_RESTARTS} restarts")
        return report
    report["restarts"] = restarts
    with open(stamp) as f:
        report["kill_to_resume_s"] = float(f.read()) - t_kill

    bad = _compare(ref_out, got_out)
    report["differences"] = bad[:10]
    report["ok"] = not bad
    if bad:
        report["error"] = ("resumed run is not bit-identical to the "
                           "uninterrupted reference")
    elif own_dir:
        shutil.rmtree(tmp, ignore_errors=True)
        report["work_dir"] = None
    return report


def _elastic_ref(args) -> int:
    from deeplearning4j_tpu_torch.parallel import elastic_smoke as es
    losses, params, dev = es.reference(dict(es.DEFAULTS,
                                            device=args.device))
    with open(args.out, "w") as f:
        json.dump({"losses": {str(k): v for k, v in losses.items()},
                   "params": {k: v.tolist() for k, v in params.items()},
                   "device": dev}, f)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="run the kill/resume bit-parity smoke drill")
    ap.add_argument("--with-corruption", action="store_true",
                    help="additionally corrupt the newest checkpoint "
                         "before resuming (drills the fallback path)")
    ap.add_argument("--elastic-smoke", dest="elastic_smoke",
                    action="store_true",
                    help="run the multi-process SIGKILL shrink + grow "
                         "membership drill (parallel/elastic_smoke.py)")
    _common.add_device_arg(ap)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--elastic-child", dest="elastic_child", nargs=6,
                    metavar="ARG", help=argparse.SUPPRESS)
    ap.add_argument("--elastic-ref", dest="elastic_ref",
                    action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    ap.add_argument("--ckpt-dir", dest="ckpt_dir", help=argparse.SUPPRESS)
    ap.add_argument("--ckpt-freq", dest="ckpt_freq", type=int, default=5,
                    help=argparse.SUPPRESS)
    ap.add_argument("--kill-at", dest="kill_at", type=int,
                    help=argparse.SUPPRESS)
    ap.add_argument("--resume", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--stamp", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return run_child(args)
    if args.elastic_child:
        from deeplearning4j_tpu_torch.parallel import elastic_smoke
        return elastic_smoke.main(["--child", *args.elastic_child])
    if args.elastic_ref:
        return _elastic_ref(args)
    if args.elastic_smoke:
        from deeplearning4j_tpu_torch.parallel import elastic_smoke
        return elastic_smoke.main(["--device", args.device])
    if args.smoke or args.with_corruption:
        report = smoke(args.with_corruption, args.device)
        if report["ok"]:
            print(f"fault-drill smoke OK: kill@{KILL_AT} + resume "
                  f"reproduced the uninterrupted {EPOCHS * 10}-step run "
                  f"bit-identically"
                  + (" (with corrupted-newest fallback)"
                     if args.with_corruption else "")
                  + f"; kill to first resumed step "
                    f"{report['kill_to_resume_s']:.2f} s")
        else:
            print(f"FAIL: {report.get('error')}", file=sys.stderr)
            for b in report.get("differences", []):
                print(f"  {b}", file=sys.stderr)
        print(json.dumps({"fault_drill": report}, default=str))
        return 0 if report["ok"] else 1
    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
