"""What the port's drivers and examples share: the `--device` flag, the
card's label beside every number, the ledgers' directory and the
environment of a spawned child."""

from __future__ import annotations

import json
import os
import subprocess
from pathlib import Path

#: the checkout holding the package (a child runs `-m` from here)
REPO_ROOT = Path(__file__).resolve().parents[2]
#: where the drivers write their ledgers by default (git-ignored)
DRIVER_DIR = REPO_ROOT / "build" / "drivers"


def add_device_arg(ap):
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; raises "
                         "when CUDA is absent, pass cpu for the plain "
                         "PyTorch path)")


def parse_device(argv, description):
    """An example's command line (`--device` alone), resolved."""
    import argparse
    from deeplearning4j_tpu_torch.device import resolve_device
    ap = argparse.ArgumentParser(description=description)
    add_device_arg(ap)
    return resolve_device(ap.parse_args(argv).device)


def card_label(device) -> str:
    """`cpu`, or `cuda: <name>, <power limit>` as `nvidia-smi` reports
    them (the card's name from torch when `nvidia-smi` is absent)."""
    import torch
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        smi = []
    idx = device.index or 0
    line = smi[idx] if len(smi) > idx else torch.cuda.get_device_name(idx)
    return f"cuda: {line}"


def sync(device):
    """Wait for the card's queued work (a timed window closes here)."""
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def default_out(name: str) -> str:
    return str(DRIVER_DIR / name)


def write_ledger(path, record):
    """Write a driver's JSON ledger. A committed `BENCH_*.json` name is
    refused: those are the TPU package's records."""
    p = Path(path)
    if p.name.startswith("BENCH_"):
        raise ValueError(f"{p.name}: BENCH_*.json files are the TPU "
                         f"package's committed records; write the port's "
                         f"ledger elsewhere (default {DRIVER_DIR})")
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "w") as f:
        json.dump(record, f, indent=2, sort_keys=True, default=str)
        f.write("\n")
    return str(p)


def child_env(**extra):
    """The environment of a spawned `python -m deeplearning4j_tpu_torch...`
    child: this checkout first on `PYTHONPATH`."""
    env = dict(os.environ)
    path = env.get("PYTHONPATH")
    env["PYTHONPATH"] = (str(REPO_ROOT) if not path
                         else f"{REPO_ROOT}{os.pathsep}{path}")
    env.update({k: str(v) for k, v in extra.items()})
    return env
