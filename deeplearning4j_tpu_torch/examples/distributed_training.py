"""Data-parallel training over a device mesh with round stats + an HTML
timeline (ParallelWrapper / TrainingMaster example role). The mesh is
`parallel.make_mesh` over `N_WORKERS` devices: the visible cards when
there are that many, else the given device repeated (on one card the
replicas take turns: a cost, never a speed-up)."""
from deeplearning4j_tpu_torch.common.updaters import Adam
from deeplearning4j_tpu_torch.datasets.fetchers import load_iris
from deeplearning4j_tpu_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import (
    MeshSpec, ParameterAveragingTrainingMaster, make_mesh)
from deeplearning4j_tpu_torch.scripts import _common

N_WORKERS = 4
EPOCHS = 30


def mesh_devices(device, n):
    """`n` mesh devices: the first n cards when the machine has them,
    else `device` repeated."""
    import torch
    if device.type == "cuda" and torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)]
    return [device] * n


def main(argv=None):
    device = _common.parse_device(argv, __doc__)
    x, y = load_iris()
    conf = (NeuralNetConfiguration.builder().seed(42).updater(Adam(0.02))
            .list()
            .layer(DenseLayer(n_out=16, activation="relu"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(4))
            .build())
    net = MultiLayerNetwork(conf, device=device).init()

    devices = mesh_devices(device, N_WORKERS)
    mesh = make_mesh(MeshSpec.of(data=len(devices)), devices=devices)
    master = ParameterAveragingTrainingMaster(
        batch_size_per_worker=max(1, 64 // len(devices)),
        averaging_frequency=2, mesh=mesh, collect_training_stats=True)
    master.execute_training(net, (x, y), epochs=EPOCHS)
    stats = master.get_training_stats()
    print("phase totals (ms):", stats.phase_totals_ms())
    _common.DRIVER_DIR.mkdir(parents=True, exist_ok=True)
    print("timeline ->", stats.export_html(
        str(_common.DRIVER_DIR / "training_timeline.html")))
    return net, stats


if __name__ == "__main__":
    main()
