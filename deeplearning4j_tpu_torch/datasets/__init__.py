from deeplearning4j_tpu_torch.datasets.iterator import (
    ArrayDataSetIterator,
    DataSet,
    as_iterator,
)

__all__ = ["ArrayDataSetIterator", "DataSet", "as_iterator"]
