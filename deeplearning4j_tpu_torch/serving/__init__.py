"""Serving tier (counterpart of `deeplearning4j_tpu/serving/`): the
paged KV pool, the continuous-batching engine and server, the request
plane's wire frames and the disaggregated prefill/decode workers. The
fleet planes (registry, fleet, router, replicas) are not ported yet."""

from deeplearning4j_tpu_torch.serving.disagg import (
    DecodeWorker,
    PrefillWorker,
    run_disaggregated,
)
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
from deeplearning4j_tpu_torch.serving.wire import WireFormatError

__all__ = ["GARBAGE_BLOCK", "BlockAllocator", "DecodeWorker",
           "GenerationServer", "PagedDecodeEngine", "PagedKVPool",
           "PrefillWorker", "RadixPrefixCache", "ServerDrainingError",
           "ServerStoppedError", "ShedError", "TokenStream",
           "WireFormatError", "blocks_needed", "bucket_len",
           "run_disaggregated"]
