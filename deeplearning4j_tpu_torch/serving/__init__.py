"""Serving tier: paged KV pool, continuous-batching engine and server."""

from deeplearning4j_tpu_torch.serving.engine import (
    PagedDecodeEngine,
    bucket_len,
)
from deeplearning4j_tpu_torch.serving.paged import (
    GARBAGE_BLOCK,
    BlockAllocator,
    PagedKVPool,
    RadixPrefixCache,
    blocks_needed,
)
from deeplearning4j_tpu_torch.serving.server import (
    GenerationServer,
    ServerDrainingError,
    ServerStoppedError,
    ShedError,
    TokenStream,
)

__all__ = ["GARBAGE_BLOCK", "BlockAllocator", "GenerationServer",
           "PagedDecodeEngine", "PagedKVPool", "RadixPrefixCache",
           "ServerDrainingError",
           "ServerStoppedError", "ShedError", "TokenStream", "blocks_needed",
           "bucket_len"]
