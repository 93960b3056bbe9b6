"""S3 upload and download, and S3-backed DataSet iteration (counterpart
of `deeplearning4j_tpu/aws/s3.py`; reference `S3Uploader.java`,
`aws/s3/reader/`, `BaseS3DataSetIterator.java`). boto3 is optional and
imported lazily."""

from __future__ import annotations

import io
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet


def _boto3():
    try:
        import boto3
    except ImportError as e:
        raise ImportError(
            "AWS adapters need the boto3 package (not installed here); "
            "install boto3 to use S3Uploader/S3Downloader") from e
    return boto3


class S3Uploader:
    def __init__(self, bucket: str, client=None):
        self.bucket = bucket
        self._client = client or _boto3().client("s3")

    def upload(self, local_path, key: Optional[str] = None):
        local_path = Path(local_path)
        self._client.upload_file(str(local_path), self.bucket,
                                 key or local_path.name)


class S3Downloader:
    def __init__(self, bucket: str, client=None):
        self.bucket = bucket
        self._client = client or _boto3().client("s3")

    def download(self, key: str, dest):
        self._client.download_file(self.bucket, key, str(dest))

    def list_keys(self, prefix: str = "") -> List[str]:
        resp = self._client.list_objects_v2(Bucket=self.bucket,
                                            Prefix=prefix)
        return [o["Key"] for o in resp.get("Contents", [])]


class S3DataSetIterator:
    """Iterate DataSets stored as .npz objects under an S3 prefix
    (reference `BaseS3DataSetIterator`). `fetch_fn(key) -> bytes` is
    injectable, so the iterator works against any object store."""

    def __init__(self, keys: List[str], fetch_fn: Callable[[str], bytes]):
        self.keys = list(keys)
        self.fetch_fn = fetch_fn
        self._pos = 0

    @staticmethod
    def from_bucket(bucket: str, prefix: str = "", client=None):
        dl = S3Downloader(bucket, client)

        def fetch(key):
            buf = io.BytesIO()
            dl._client.download_fileobj(bucket, key, buf)
            return buf.getvalue()

        return S3DataSetIterator(dl.list_keys(prefix), fetch)

    def reset(self):
        self._pos = 0

    def has_next(self):
        return self._pos < len(self.keys)

    def next(self) -> DataSet:
        data = self.fetch_fn(self.keys[self._pos])
        self._pos += 1
        npz = np.load(io.BytesIO(data))
        return DataSet(npz["features"],
                       npz["labels"] if "labels" in npz else None)

    def __iter__(self):
        self.reset()
        while self.has_next():
            yield self.next()
