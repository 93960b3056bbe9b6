"""TextGenerationLSTM (counterpart of
`deeplearning4j_tpu/zoo/textgenlstm.py:16-53`): two stacked
GravesLSTM(`hidden`) layers and a softmax RnnOutputLayer over the
character vocabulary, RmsProp(1e-2), Xavier init, truncated BPTT of
`tbptt_length` steps. `conf()` equals the JAX model's as a dict, and
`init(seed)` draws the JAX model's weights from the same keys.

The packaged TEXT checkpoint is the char-LM the JAX package trained on
its own documentation (`textgen_docs.zip`: two GravesLSTM(128), vocab
77); `init_pretrained(PretrainedType.TEXT)` checks its sha256 and
restores it, and `pretrained_charset()` is the charset it was trained
with (index vocab-1 is the unknown slot).
"""

from __future__ import annotations

from typing import Optional

from deeplearning4j_tpu_torch.common.updaters import RmsProp
from deeplearning4j_tpu_torch.common.weights import WeightInit
from deeplearning4j_tpu_torch.nn.conf.builder import (
    BackpropType,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers import GravesLSTM, RnnOutputLayer
from deeplearning4j_tpu_torch.zoo.base import (
    PretrainedType,
    ZooModel,
    packaged_weight_entry,
)


class TextGenerationLSTM(ZooModel):
    packaged = {PretrainedType.TEXT: "textgen_docs.zip"}

    def __init__(self, vocab_size: int = 77, hidden: int = 256,
                 seed: int = 123, tbptt_length: int = 50):
        super().__init__(num_classes=vocab_size, seed=seed)
        self.vocab_size = vocab_size
        self.hidden = hidden
        self.tbptt_length = tbptt_length

    def conf(self):
        return (NeuralNetConfiguration.builder()
                .seed(self.seed)
                .updater(RmsProp(1e-2))
                .weight_init(WeightInit.XAVIER)
                .list()
                .layer(GravesLSTM(n_in=self.vocab_size, n_out=self.hidden,
                                  activation="tanh"))
                .layer(GravesLSTM(n_in=self.hidden, n_out=self.hidden,
                                  activation="tanh"))
                .layer(RnnOutputLayer(n_in=self.hidden,
                                      n_out=self.vocab_size,
                                      activation="softmax", loss="mcxent"))
                .backprop_type(BackpropType.TRUNCATED_BPTT,
                               self.tbptt_length)
                .build())


    @staticmethod
    def pretrained_charset() -> Optional[str]:
        """The charset of the packaged TEXT checkpoint (None without
        one)."""
        entry = packaged_weight_entry("textgen_docs.zip")
        return None if entry is None else entry.get("charset")
