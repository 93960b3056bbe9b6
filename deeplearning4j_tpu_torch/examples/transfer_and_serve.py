"""Transfer learning + checkpoint + streaming serving: fine-tune a
feature extractor, save, serve over an in-process route (dl4j-examples
TransferLearning + streaming role)."""
import os
import shutil
import tempfile

from deeplearning4j_tpu_torch.common.updaters import Adam
from deeplearning4j_tpu_torch.datasets.fetchers import load_iris
from deeplearning4j_tpu_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.scripts import _common
from deeplearning4j_tpu_torch.streaming import (
    LocalQueueTransport, NDArrayConsumer, NDArrayPublisher, ServingRoute)
from deeplearning4j_tpu_torch.transferlearning import TransferLearning
from deeplearning4j_tpu_torch.util.serializer import ModelSerializer

BASE_EPOCHS = 40
TUNE_EPOCHS = 10


def main(argv=None):
    device = _common.parse_device(argv, __doc__)
    x, y = load_iris()
    conf = (NeuralNetConfiguration.builder().seed(1).updater(Adam(0.02))
            .list()
            .layer(DenseLayer(n_out=32, activation="relu"))
            .layer(DenseLayer(n_out=16, activation="relu"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(4))
            .build())
    base = MultiLayerNetwork(conf, device=device).init()
    base.fit(x, y, epochs=BASE_EPOCHS, batch_size=50)

    # freeze the trunk, replace the head, fine-tune
    tuned = (TransferLearning.Builder(base)
             .set_feature_extractor(1)
             .n_out_replace(2, 3)
             .build(device=device))
    tuned.fit(x, y, epochs=TUNE_EPOCHS, batch_size=50)

    tmp = tempfile.mkdtemp(prefix="iris_model_")
    try:
        path = os.path.join(tmp, "iris_model.zip")
        ModelSerializer.write_model(tuned, path)
        transport = LocalQueueTransport()
        route = ServingRoute(transport, "in", "out", model_uri=path,
                             device=device)
        NDArrayPublisher(transport, "in").publish(x[:5])
        route.run(max_messages=1, timeout=0.5)
        served = NDArrayConsumer(transport, "out").consume(timeout=1.0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    import numpy as np
    pred = np.asarray(served).argmax(1)
    print("served:", pred)
    return pred


if __name__ == "__main__":
    main()
