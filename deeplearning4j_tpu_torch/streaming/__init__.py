"""NDArray streaming (counterpart of `deeplearning4j_tpu/streaming/`):
the ND4T wire format and its transports. `LocalQueueTransport` is the
in-process transport, `LocalLogTransport` its offset-addressable
sibling, and `KafkaTransport` needs the optional kafka-python package.
"""

from deeplearning4j_tpu_torch.streaming.ndarray import (
    KafkaTransport,
    LocalLogTransport,
    LocalQueueTransport,
    NDArrayConsumer,
    NDArrayPublisher,
    Transport,
    deserialize_ndarray,
    serialize_ndarray,
)

__all__ = ["KafkaTransport", "LocalLogTransport", "LocalQueueTransport",
           "NDArrayConsumer", "NDArrayPublisher", "Transport",
           "deserialize_ndarray", "serialize_ndarray"]
