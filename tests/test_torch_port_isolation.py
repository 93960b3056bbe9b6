"""The port stands alone: importing `deeplearning4j_tpu_torch` and every
module in it loads neither `jax` nor any `deeplearning4j_tpu` module.
Checked in a fresh interpreter (this test process has JAX loaded)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import deeplearning4j_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
             or m == "deeplearning4j_tpu"
             or m.startswith("deeplearning4j_tpu."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_no_jax_package():
    import json
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    for mod in ("kernels.layernorm", "kernels.flash_attention",
                "kernels.fused_adam", "kernels.build", "common.updaters",
                "common.losses", "datasets.iterator", "nn.multilayer",
                "zoo.transformer", "serving.engine", "serving.server",
                "util.jax_params", "parallel.mesh", "parallel.context",
                "parallel.ring", "parallel.ulysses", "common.schedules",
                "common.activations", "common.weights",
                "common.distributions", "nd.dtype", "fault.errors",
                "fault.state", "nn.conf.inputs", "nn.conf.dropout",
                "nn.conf.weightnoise", "nn.conf.constraints",
                "nn.conf.preprocessors", "nn.conf.builder", "nn.layers.base",
                "util.serializer"):
        assert f"deeplearning4j_tpu_torch.{mod}" in res["modules"]
    assert res["bad"] == []


def test_port_sources_never_name_jax():
    """No source file of the port imports jax or the JAX package (the
    runtime probe above only sees modules actually imported)."""
    import re
    pat = re.compile(r"^\s*(import|from)\s+(jax|deeplearning4j_tpu)\b",
                     re.M)
    root = os.path.join(REPO, "deeplearning4j_tpu_torch")
    hits = []
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(d, f)) as fh:
                    if pat.search(fh.read()):
                        hits.append(f)
    assert hits == []
