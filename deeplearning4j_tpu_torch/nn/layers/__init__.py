from deeplearning4j_tpu_torch.nn.layers.attention import MultiHeadAttention
from deeplearning4j_tpu_torch.nn.layers.base import Layer, layer_from_dict
from deeplearning4j_tpu_torch.nn.layers.convolution import (
    ConvolutionLayer,
    ConvolutionMode,
    PoolingMode,
    SubsamplingLayer,
    ZeroPaddingLayer,
)
from deeplearning4j_tpu_torch.nn.layers.feedforward import (
    ActivationLayer,
    DenseLayer,
    DropoutLayer,
    EmbeddingLayer,
    OutputLayer,
)
from deeplearning4j_tpu_torch.nn.layers.normalization import (
    BatchNormalization,
    LayerNormalization,
    LocalResponseNormalization,
    layer_norm_reference,
)
from deeplearning4j_tpu_torch.nn.layers.pooling import (
    GlobalPoolingLayer,
    PoolingType,
)
from deeplearning4j_tpu_torch.nn.layers.recurrent import (
    LSTM,
    BaseRecurrentLayer,
    GravesBidirectionalLSTM,
    GravesLSTM,
    LastTimeStep,
    RnnOutputLayer,
    SimpleRnn,
)
from deeplearning4j_tpu_torch.nn.layers.training import CenterLossOutputLayer
from deeplearning4j_tpu_torch.nn.layers.transformer import (
    PositionalEncodingLayer,
    TransformerEncoderBlock,
    stream_budget,
)

__all__ = ["ActivationLayer", "BaseRecurrentLayer", "BatchNormalization",
           "CenterLossOutputLayer", "ConvolutionLayer", "ConvolutionMode",
           "DenseLayer", "DropoutLayer", "EmbeddingLayer",
           "GlobalPoolingLayer", "GravesBidirectionalLSTM", "GravesLSTM",
           "LSTM", "LastTimeStep", "Layer", "LayerNormalization",
           "LocalResponseNormalization", "MultiHeadAttention", "OutputLayer",
           "PoolingMode", "PoolingType", "PositionalEncodingLayer",
           "RnnOutputLayer", "SimpleRnn", "SubsamplingLayer",
           "ZeroPaddingLayer", "TransformerEncoderBlock", "layer_from_dict",
           "layer_norm_reference", "stream_budget"]
