"""Training-health diagnostics end to end: in-step per-layer stats,
the non-finite watchdog, and the live training UI.

    python -m deeplearning4j_tpu_torch.examples.training_diagnostics

What it shows:
- a model built with ``.diagnostics("skip")``: the train step computes
  per-layer gradient/update/param/activation statistics on the device
  (one batched transfer per report), and the watchdog discards
  non-finite updates on the device;
- a deliberate learning-rate spike mid-run that would silently destroy
  the model — the ``skip`` policy rides through it and the counters
  record it;
- the stats flowing through StatsListener into the training UI
  (`/train/overview` training-health strip) and the Prometheus
  `/metrics` route (``training_*`` / ``watchdog_*`` families).
"""
import numpy as np

from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.common.schedules import MapSchedule
from deeplearning4j_tpu_torch.common.updaters import Sgd
from deeplearning4j_tpu_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.scripts import _common
from deeplearning4j_tpu_torch.ui import UIServer
from deeplearning4j_tpu_torch.ui.stats import StatsListener
from deeplearning4j_tpu_torch.ui.storage import InMemoryStatsStorage

EPOCHS = 2


def main(argv=None):
    device = _common.parse_device(argv, __doc__)
    monitor.enable()

    # lr spikes to inf at iteration 10 — a classic silent-failure
    # injection: the update goes non-finite, the watchdog discards it
    # on the device, and training continues from the pre-spike params
    lr = MapSchedule({0: 0.05, 10: float("inf"), 11: 0.05})
    lb = (NeuralNetConfiguration.builder().seed(7).updater(Sgd(lr)).list())
    for _ in range(4):
        lb = lb.layer(DenseLayer(n_in=16, n_out=16, activation="tanh"))
    conf = (lb.layer(OutputLayer(n_in=16, n_out=4, activation="softmax",
                                 loss="mcxent"))
            .set_input_type(InputType.feed_forward(16))
            .diagnostics("skip")   # stats + watchdog: discard bad updates
            .build())
    net = MultiLayerNetwork(conf, device=device).init()

    storage = InMemoryStatsStorage()
    net.set_listeners(StatsListener(storage, collect_histograms=False))

    rng = np.random.default_rng(0)
    x = rng.standard_normal((640, 16)).astype(np.float32)
    w = rng.standard_normal((16, 4))
    y = np.eye(4, dtype=np.float32)[np.argmax(x @ w, axis=1)]
    net.fit(x, y, epochs=EPOCHS, batch_size=32, shuffle=False)

    d = net._last_diagnostics
    print("\nlatest per-layer internals (from the step's statistics):")
    for key in sorted(d["params"]):
        st = d["params"][key]
        print(f"  {key:6s} |g|={st['grad_mm']:.3e} |Δ|={st['upd_mm']:.3e} "
              f"ratio={st['ratio']:.3e}")
    for lk in sorted(d["activations"]):
        st = d["activations"][lk]
        print(f"  act {lk}: mean={st['mean']:+.3f} std={st['std']:.3f} "
              f"dead={st['dead']:.2f}")
    print(f"watchdog: nonfinite={net._diag.nonfinite_total} "
          f"skipped={net._diag.skipped_total} (the lr spike)")

    server = UIServer().start()
    try:
        server.attach(storage)
        print(f"\ntraining UI: http://127.0.0.1:{server.port}/train/overview "
              f"(training-health strip; ?lang=ja / ?lang=zh)")
        print(f"metrics:     http://127.0.0.1:{server.port}/metrics "
              f"(training_* / watchdog_* families)")
    finally:
        server.stop()
    return net


if __name__ == "__main__":
    main()
