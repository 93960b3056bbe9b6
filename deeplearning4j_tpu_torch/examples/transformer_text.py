"""Transformer text classifier (beyond-reference long-context model):
detect whether a keyword token appears anywhere in the sequence."""
import numpy as np

from deeplearning4j_tpu_torch.nn.layers.pooling import PoolingType
from deeplearning4j_tpu_torch.scripts import _common
from deeplearning4j_tpu_torch.zoo.transformer import TransformerClassifier

EPOCHS = 15
N_EXAMPLES = 512


def main(argv=None):
    device = _common.parse_device(argv, __doc__)
    rng = np.random.default_rng(0)
    n, T, V = N_EXAMPLES, 24, 40
    ids = rng.integers(1, V, (n, T))
    labels = rng.random(n) < 0.5
    for i in np.nonzero(labels)[0]:
        ids[i, rng.integers(0, T)] = 0           # plant the keyword
    y = np.eye(2, dtype=np.float32)[labels.astype(int)]

    net = TransformerClassifier(vocab_size=V, num_classes=2, d_model=48,
                                n_layers=2, n_heads=4,
                                pooling=PoolingType.MAX,
                                seed=7).init(device=device)
    net.fit(ids.astype(np.float32), y, epochs=EPOCHS, batch_size=64,
            steps_per_execution=4)
    pred = net.output(ids.astype(np.float32)).argmax(1).cpu().numpy()
    acc = float((pred == labels.astype(int)).mean())
    print("train accuracy:", acc)
    return acc


if __name__ == "__main__":
    main()
