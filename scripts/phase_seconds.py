"""Seconds of chosen `chip_smoke.py` phases of one checkout, on one CUDA
card: the A/B of a change to a phase's cost against its parent, in one
call, in turns (parent, change, change, parent).

    python3 scripts/phase_seconds.py --tree PATH --phases regularized,cnn_zoo

`--tree` is the root of the checkout whose `chip_smoke.py` (and port
package) runs; each `--phases` name is a `phase_<name>` function of it,
called at full size after the checkout's kernels are built. Prints one
JSON line: the tree, each phase's seconds and the failed checks. Exits
2 without CUDA, 1 when a check failed.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=".")
    ap.add_argument("--phases", required=True)
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        print("phase_seconds: needs a CUDA card", file=sys.stderr)
        return 2
    cs = importlib.import_module("chip_smoke")
    if os.path.dirname(os.path.abspath(cs.__file__)) != tree:
        raise RuntimeError(f"chip_smoke imported from {cs.__file__}, not "
                           f"{tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    report, fails = {}, cs.Failures()
    cs.phase_build(report, fails)
    seconds = {}
    for name in args.phases.split(","):
        t0 = time.perf_counter()
        getattr(cs, f"phase_{name}")(device, report, fails)
        seconds[name] = time.perf_counter() - t0
    print(json.dumps({"tree": args.tree, "seconds": seconds,
                      "failures": list(fails)}), flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
