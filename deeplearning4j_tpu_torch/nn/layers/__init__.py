from deeplearning4j_tpu_torch.nn.layers.attention import MultiHeadAttention
from deeplearning4j_tpu_torch.nn.layers.base import Layer, layer_from_dict
from deeplearning4j_tpu_torch.nn.layers.feedforward import (
    DenseLayer,
    EmbeddingLayer,
)
from deeplearning4j_tpu_torch.nn.layers.normalization import (
    LayerNormalization,
    layer_norm_reference,
)
from deeplearning4j_tpu_torch.nn.layers.recurrent import (
    BaseRecurrentLayer,
    RnnOutputLayer,
)
from deeplearning4j_tpu_torch.nn.layers.transformer import (
    PositionalEncodingLayer,
    TransformerEncoderBlock,
    stream_budget,
)

__all__ = ["BaseRecurrentLayer", "DenseLayer", "EmbeddingLayer", "Layer",
           "LayerNormalization", "MultiHeadAttention",
           "PositionalEncodingLayer", "RnnOutputLayer",
           "TransformerEncoderBlock", "layer_from_dict",
           "layer_norm_reference", "stream_budget"]
