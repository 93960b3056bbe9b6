"""Shared pieces of the port's driver tests (`test_torch_port_drivers`,
`_drills`, `_drills_serving`, `_examples`, `_phase26`): the JAX
package's repo-level scripts loaded by path (they are scripts, not a
package), the key structure of a ledger dict literal in a JAX script's
source, and a port driver run as a user runs it.
"""

from __future__ import annotations

import ast
import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_jax_script(name):
    """`scripts/<name>.py` of the repository as a module (not run)."""
    path = os.path.join(REPO, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _keys(node):
    """A dict literal's keys, nested where a value is a dict literal."""
    out = {}
    for k, v in zip(node.keys, node.values):
        if isinstance(k, ast.Constant):
            out[k.value] = _keys(v) if isinstance(v, ast.Dict) else None
    return out


def jax_ledger_keys(script, var):
    """The nested keys of the dict literal assigned to `var` in
    `scripts/<script>.py`'s `main` (its ledger)."""
    with open(os.path.join(REPO, "scripts", f"{script}.py")) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    for node in ast.walk(main):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(isinstance(t, ast.Name) and t.id == var
                        for t in node.targets):
            return _keys(node.value)
    raise LookupError(f"no dict literal {var} in {script}.main")


def assert_keys_cover(want, got, where=""):
    """Every key of `want` (a `jax_ledger_keys` tree) is in `got`, with
    the same nested keys where `want` has a dict literal."""
    missing = sorted(set(want) - set(got))
    assert not missing, f"{where}: missing {missing}"
    for k, sub in want.items():
        if sub is not None:
            assert isinstance(got[k], dict), f"{where}.{k} is not a dict"
            assert set(got[k]) == set(sub), (
                f"{where}.{k}: {sorted(set(got[k]) ^ set(sub))}")


def run_port_module(module, *argv, timeout=600):
    """`python -m deeplearning4j_tpu_torch.<module> argv...` from the
    checkout, one torch thread in the child; returns (rc, stdout,
    stderr) and the last stdout line parsed as JSON (or None)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", f"deeplearning4j_tpu_torch.{module}",
         *map(str, argv)], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=timeout)
    lines = out.stdout.strip().splitlines()
    last = None
    if lines and lines[-1].startswith("{"):
        last = json.loads(lines[-1])
    return out.returncode, out.stdout, out.stderr, last
