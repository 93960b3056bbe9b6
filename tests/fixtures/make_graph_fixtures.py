"""Write the ComputationGraph bridge fixtures with the JAX package:

    JAX_PLATFORMS=cpu python tests/fixtures/make_graph_fixtures.py [OUT]

OUT defaults to tests/fixtures/bridge/. It holds

- `resnet_small.zip`: the JAX `ModelSerializer` zip of `SmallResNet`, a
  ResNet-50 graph (`deeplearning4j_tpu/zoo/resnet50.py`: the 7x7/2 stem
  conv + BatchNorm + relu and 3x3/2 max pool, bottleneck blocks with
  `ElementWiseVertex("add")`, global average pooling, softmax output,
  Nesterovs, l2 1e-4) cut to one stage of two bottleneck blocks at
  width `WIDTH`, on [`HW`, `HW`, 3] images and `CLASSES` classes, after
  `STEPS` steps at B=`B` (so its BatchNorm running statistics and
  Nesterov's v are not their initial values);
- `resnet_small_golden.npz`: from the JAX graph restored from that zip,
  `output()` on stored images (inference: the running statistics), and
  the loss, per-leaf float64 sums and sums of squares of the params and
  of the running state after one more `fit` step on stored batches.

`tests/test_torch_port_graph.py` regenerates both in a temporary
directory and holds them to the committed files.
"""

from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

HW, CLASSES, WIDTH = 32, 10, 8
SEED, STEPS, B = 11, 3, 4
LR = 0.005       # the JAX benchmark's Nesterovs rate (bench.py:250-259)


def small_resnet(base):
    """`base` (either package's ResNet50 class) with one stage of two
    bottleneck blocks of width WIDTH."""
    class SmallResNet(base):
        STAGES = [(2, WIDTH)]
    return SmallResNet(num_classes=CLASSES, seed=SEED, height=HW, width=HW)


def images(seed: int, n: int):
    """n standard-normal NHWC images and one-hot labels."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, HW, HW, 3)).astype(np.float32)
    y = np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, n)]
    return x, y


def conf(base, updater):
    """The configuration with every layer's updater set to `updater`."""
    c = small_resnet(base).conf()
    for node in c.nodes.values():
        if node.layer is not None:
            node.layer.updater = updater
    return c


def make(out: str) -> None:
    from deeplearning4j_tpu.common.updaters import Nesterovs
    from deeplearning4j_tpu.nn.graph import ComputationGraph
    from deeplearning4j_tpu.util.serializer import ModelSerializer
    from deeplearning4j_tpu.zoo.resnet50 import ResNet50

    os.makedirs(out, exist_ok=True)
    net = ComputationGraph(conf(ResNet50, Nesterovs(LR, 0.9))).init(SEED)
    x, y = images(1, STEPS * B)
    net.fit(x, y, batch_size=B)
    zip_path = os.path.join(out, "resnet_small.zip")
    ModelSerializer.write_model(net, zip_path)

    net = ModelSerializer.restore_model(zip_path)
    ex, _ = images(2, B)
    golden = dict(x=ex, probs=np.asarray(net.output(ex)))
    sx, sy = images(3, B)
    net.fit(sx, sy, batch_size=B)
    golden.update(step_x=sx, step_y=sy, loss=np.float64(net.score_value),
                  iteration_count=np.int64(net.iteration_count))
    for tree, tag in ((net.params, "param"), (net.net_state, "state")):
        for lk, lp in tree.items():
            for name, arr in lp.items():
                a = np.asarray(arr, np.float64)
                golden[f"sum/{tag}/{lk}/{name}"] = a.sum()
                golden[f"sumsq/{tag}/{lk}/{name}"] = (a * a).sum()
    np.savez(os.path.join(out, "resnet_small_golden.npz"), **golden)


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    make(sys.argv[1] if len(sys.argv) > 1 else os.path.join(HERE, "bridge"))
