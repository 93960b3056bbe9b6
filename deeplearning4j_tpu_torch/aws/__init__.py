"""S3 adapters (counterpart of `deeplearning4j_tpu/aws/`; reference
deeplearning4j-aws: `S3Uploader.java`, `BaseS3DataSetIterator`).

boto3 is imported only when a client is made without one given: a host
without it gets an ImportError naming it, and `S3DataSetIterator` takes
any fetch function, so the iterator runs against any object store.
"""

from deeplearning4j_tpu_torch.aws.s3 import (
    S3DataSetIterator,
    S3Downloader,
    S3Uploader,
)
