from deeplearning4j_tpu_torch.datasets.iterator import (
    ArrayDataSetIterator,
    DataSet,
    ListDataSetIterator,
    as_iterator,
)

__all__ = ["ArrayDataSetIterator", "DataSet", "ListDataSetIterator",
           "as_iterator"]
