"""The port stands alone: importing `deeplearning4j_tpu_torch` and every
module in it loads neither `jax`, `ml_dtypes`, `h5py`, `keras`, PIL
(the UI writes its PNGs with the standard library) nor any
`deeplearning4j_tpu` module, and leaves torch's thread count alone.
Checked in a fresh interpreter (this test process has JAX loaded).
`chip_smoke.py` imports none of them either. The test processes
themselves cap torch's threads under pytest-xdist
(`tests/torch_port_threads.py`)."""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import torch
threads = torch.get_num_threads()
import deeplearning4j_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
             or m == "ml_dtypes" or m.startswith("ml_dtypes.")
             or m == "h5py" or m.startswith("h5py.")
             or m == "keras" or m.startswith("keras.")
             or m == "PIL" or m.startswith("PIL.")
             or m == "deeplearning4j_tpu"
             or m.startswith("deeplearning4j_tpu."))
print(json.dumps({"modules": names, "bad": bad,
                  "threads": [threads, torch.get_num_threads()]}))
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
                "util.serializer", "nd.quant", "serving.paged",
                "common.prng", "kernels.dropout", "optimize.gradients",
                "optimize.listeners", "eval.evaluation", "eval.roc",
                "eval.regression", "nn.layers.pooling", "nn.container",
                "nn.graph", "nn.conf.graph", "nn.layers.convolution",
                "nn.layers.normalization", "zoo.base", "zoo.resnet50",
                "nn.layers.recurrent", "zoo.textgenlstm",
                "nn.layers.training", "zoo.lenet", "zoo.simplecnn",
                "zoo.alexnet", "zoo.vgg", "zoo.googlenet",
                "zoo.inceptionresnet", "zoo.facenet",
                "datasets.multidataset", "datasets.normalizers",
                "optimize.solvers", "fault.checkpointer", "fault.listener",
                "fault.resume", "fault.drill", "earlystopping.conditions",
                "earlystopping.config", "earlystopping.savers",
                "earlystopping.scorecalc", "earlystopping.trainer",
                "transferlearning.transfer", "monitor", "monitor.registry",
                "monitor.tracer", "monitor.flightrec", "monitor.collectors",
                "monitor.listener", "monitor.diagnostics",
                "datasets.dataset", "datasets.records",
                "datasets.parallel", "datasets.fetchers", "eval.binary",
                "eval.calibration", "eval.tools", "gradientcheck",
                "streaming", "streaming.ndarray", "serving.wire",
                "serving.disagg", "monitor.reqtrace", "monitor.goodput",
                "monitor.slo", "monitor.xprof", "nn.conf.memory",
                "parallel.gradient_sharing", "parallel.collectives",
                "parallel.placement", "parallel.trainer", "parallel.stats",
                "parallel.master", "parallel.inference",
                "parallel.multihost", "parallel.multihost_smoke",
                "parallel.tensor", "parallel.pipeline",
                "parallel.pipeline_container", "util.sharded_checkpoint",
                "common.global_batch", "tenancy", "tenancy.lora",
                "tenancy.fleet", "online", "online.iterator",
                "online.normalizer", "online.trainer", "nlp",
                "nlp.tokenization", "nlp.stopwords", "nlp.sentenceiterator",
                "nlp.documentiterator", "nlp.vocab", "nlp.sequencevectors",
                "nlp.word2vec", "nlp.serializer", "nlp.paragraphvectors",
                "nlp.glove", "nlp.bagofwords", "nlp.invertedindex",
                "nlp.iterator", "graph", "graph.graph", "graph.loader",
                "graph.walkers", "graph.deepwalk", "graph.node2vec",
                "util", "util.viterbi", "util.diskqueue", "kernels.viterbi",
                "clustering", "clustering.kmeans", "clustering.vptree",
                "clustering.kdtree", "clustering.quadtree",
                "clustering.sptree", "clustering.server", "plot",
                "plot.tsne", "nlp.cjk", "nlp.japanese", "nlp.korean",
                "nlp.annotation", "util.native_build", "modelimport",
                "modelimport.hdf5", "modelimport.keras",
                "datasets.native_csv", "util.guesser", "ml", "ml.estimator",
                "aws", "aws.s3", "ui", "ui.i18n", "ui.components",
                "ui.stats", "ui.storage", "ui.convolutional", "ui.server"):
        assert f"deeplearning4j_tpu_torch.{mod}" in res["modules"]
    assert res["bad"] == []
    assert res["threads"][0] == res["threads"][1]


def test_port_sources_never_name_jax():
    """No source file of the port, and not `chip_smoke.py`, imports jax,
    ml_dtypes, h5py, keras or the JAX package (the runtime probe above
    only sees modules actually imported)."""
    import re
    pat = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|ml_dtypes|h5py|keras|"
        r"deeplearning4j_tpu)\b", re.M)
    root = os.path.join(REPO, "deeplearning4j_tpu_torch")
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, files in os.walk(root):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    hits = []
    for path in paths:
        with open(path) as fh:
            if pat.search(fh.read()):
                hits.append(os.path.relpath(path, REPO))
    assert len(paths) > 100 and hits == []


def test_xdist_workers_share_the_cores():
    """Under pytest-xdist a worker runs torch on its share of the cores
    (six workers on eight: one thread each); a plain run keeps torch's
    default."""
    import torch
    import torch_port_threads
    want = torch_port_threads.worker_threads()
    if want is None:
        assert "PYTEST_XDIST_WORKER" not in os.environ \
            or int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")) < 2
    else:
        assert torch.get_num_threads() == want
        assert want == max(1, len(os.sched_getaffinity(0)) // int(
            os.environ["PYTEST_XDIST_WORKER_COUNT"]))
