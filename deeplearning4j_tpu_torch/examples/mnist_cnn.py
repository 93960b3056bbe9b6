"""LeNet on MNIST — the classic first example: build, fit with
listeners, evaluate. The fetcher reads the MNIST files from its cache
and never downloads: with no cache it serves synthetic digits."""
from deeplearning4j_tpu_torch.datasets.fetchers import MnistDataSetIterator
from deeplearning4j_tpu_torch.optimize.listeners import (
    PerformanceListener, ScoreIterationListener)
from deeplearning4j_tpu_torch.scripts import _common
from deeplearning4j_tpu_torch.zoo.lenet import LeNet

N_TRAIN, N_TEST = 6000, 1000
EPOCHS = 2


def main(argv=None):
    device = _common.parse_device(argv, __doc__)
    train = MnistDataSetIterator(batch_size=128, train=True,
                                 num_examples=N_TRAIN, flatten=False)
    test = MnistDataSetIterator(batch_size=256, train=False,
                                num_examples=N_TEST, flatten=False)
    net = LeNet(num_classes=10).init(device=device)
    net.set_listeners(ScoreIterationListener(10), PerformanceListener(10))
    # steps_per_execution fuses minibatch steps into one device dispatch
    net.fit(train, epochs=EPOCHS, steps_per_execution=8)
    e = net.evaluate(test)
    print(e.stats())
    return e


if __name__ == "__main__":
    main()
