"""NDArray streaming (counterpart of `deeplearning4j_tpu/streaming/`):
the ND4T wire format and its transports, CSV lines to DataSets, and the
serve and publish routes. `LocalQueueTransport` is the in-process
transport, `LocalLogTransport` its offset-addressable sibling, and
`KafkaTransport` needs the optional kafka-python package.
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
from deeplearning4j_tpu_torch.streaming.records import csv_to_dataset
from deeplearning4j_tpu_torch.streaming.routes import (
    RecordPublishRoute,
    ServingRoute,
)

__all__ = ["KafkaTransport", "LocalLogTransport", "LocalQueueTransport",
           "NDArrayConsumer", "NDArrayPublisher", "RecordPublishRoute",
           "ServingRoute", "Transport", "csv_to_dataset",
           "deserialize_ndarray", "serialize_ndarray"]
