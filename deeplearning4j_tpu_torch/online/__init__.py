"""Online learning (counterpart of `deeplearning4j_tpu/online/`):
unbounded-stream training that publishes into the serving fleet.

- `online.iterator`: `StreamingDataSetIterator`, the unbounded
  `DataSetIterator` contract over the `streaming/` transports (cursor =
  transport offset, watermark-bounded blocking reads, fixed-shape
  batches with ragged-tail hold-back), and `lm_example`;
- `online.normalizer`: `WindowedStandardize`, sliding-window standardize
  statistics with a versioned `snapshot()` per publish;
- `online.trainer`: `OnlineTrainer` (continuous fit, registry publish,
  fault checkpoints, a bit-equal resume from the stream offset) and
  `DriftGate` (a held-out regression band that pauses publishing, never
  training).
"""

from deeplearning4j_tpu_torch.online.iterator import (
    StreamingDataSetIterator,
    lm_example,
)
from deeplearning4j_tpu_torch.online.normalizer import (
    StandardizeSnapshot,
    WindowedStandardize,
)
from deeplearning4j_tpu_torch.online.trainer import DriftGate, OnlineTrainer

__all__ = [
    "StreamingDataSetIterator", "lm_example",
    "WindowedStandardize", "StandardizeSnapshot",
    "OnlineTrainer", "DriftGate",
]
