"""Serving tier (counterpart of `deeplearning4j_tpu/serving/`): the
paged KV pool, the continuous-batching engine and server, the request
plane's wire frames, the disaggregated prefill/decode workers, and the
fleet around them: the versioned `ModelRegistry`, the hot-swapping
`FleetServer` and its `FleetAutoscaler`, the `FleetRouter` front end
with its transport plane, and replica processes behind the elastic
coordinator (`serving.replica`)."""

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
from deeplearning4j_tpu_torch.serving.registry import (
    AdapterPublishListener,
    ModelRegistry,
    RegistryPublishListener,
    VersionConflictError,
)
from deeplearning4j_tpu_torch.serving.fleet import (
    FleetAutoscaler,
    FleetServer,
)
from deeplearning4j_tpu_torch.serving.replica import (
    ReplicaClient,
    ReplicaLostError,
    ReplicaManager,
    ReplicaSet,
    ReplicaWorker,
    spawn_replica,
)
from deeplearning4j_tpu_torch.serving.router import (
    FleetClient,
    FleetRouter,
    MigratingStream,
    RemoteTokenStream,
    UnknownModelError,
)
from deeplearning4j_tpu_torch.serving.wire import WireFormatError

__all__ = ["AdapterPublishListener", "GARBAGE_BLOCK", "BlockAllocator", "DecodeWorker",
           "FleetAutoscaler", "FleetClient", "FleetRouter", "FleetServer",
           "GenerationServer", "MigratingStream", "ModelRegistry",
           "PagedDecodeEngine", "PagedKVPool", "PrefillWorker",
           "RadixPrefixCache", "RegistryPublishListener",
           "RemoteTokenStream", "ReplicaClient", "ReplicaLostError",
           "ReplicaManager", "ReplicaSet", "ReplicaWorker",
           "ServerDrainingError", "ServerStoppedError", "ShedError",
           "TokenStream", "UnknownModelError", "VersionConflictError",
           "WireFormatError", "blocks_needed", "bucket_len",
           "run_disaggregated", "spawn_replica"]
