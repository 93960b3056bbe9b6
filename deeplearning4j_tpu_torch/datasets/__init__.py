from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.fetchers import (
    Cifar10DataSetIterator,
    EmnistDataSetIterator,
    IrisDataSetIterator,
    LFWDataSetIterator,
    MnistDataSetIterator,
)
from deeplearning4j_tpu_torch.datasets.iterator import (
    ArrayDataSetIterator,
    AsyncDataSetIterator,
    BenchmarkDataSetIterator,
    DataSetIterator,
    EarlyTerminationDataSetIterator,
    ListDataSetIterator,
    MultipleEpochsIterator,
    SamplingDataSetIterator,
    TimedDataSetIterator,
    as_iterator,
)
from deeplearning4j_tpu_torch.datasets.parallel import (
    BaseParallelDataSetIterator,
    DevicePrefetchIterator,
    FileSplitParallelDataSetIterator,
    InequalityHandling,
    JointParallelDataSetIterator,
)
from deeplearning4j_tpu_torch.datasets.records import (
    CollectionRecordReader,
    CSVRecordReader,
    CSVSequenceRecordReader,
    ImageRecordReader,
    RecordReaderDataSetIterator,
    SequenceRecordReaderDataSetIterator,
)

__all__ = ["ArrayDataSetIterator", "AsyncDataSetIterator",
           "BaseParallelDataSetIterator", "BenchmarkDataSetIterator",
           "EarlyTerminationDataSetIterator", "MultipleEpochsIterator",
           "SamplingDataSetIterator", "TimedDataSetIterator", "CSVRecordReader",
           "CSVSequenceRecordReader", "Cifar10DataSetIterator",
           "CollectionRecordReader", "DataSet", "DataSetIterator",
           "DevicePrefetchIterator", "EmnistDataSetIterator",
           "FileSplitParallelDataSetIterator", "ImageRecordReader",
           "InequalityHandling", "IrisDataSetIterator",
           "JointParallelDataSetIterator", "LFWDataSetIterator",
           "ListDataSetIterator", "MnistDataSetIterator",
           "RecordReaderDataSetIterator",
           "SequenceRecordReaderDataSetIterator", "as_iterator"]
