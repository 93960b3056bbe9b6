"""Utilities (counterpart of `deeplearning4j_tpu/util/`): Viterbi
decoding and disk-backed queueing are exported here as the JAX package
exports them; the model serializer and the sharded checkpoint are
imported from their modules (`util.serializer`,
`util.sharded_checkpoint`), which import the containers."""

from deeplearning4j_tpu_torch.util.viterbi import Viterbi, viterbi_decode
from deeplearning4j_tpu_torch.util.diskqueue import DiskBasedQueue
