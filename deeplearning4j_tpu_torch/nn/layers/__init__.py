from deeplearning4j_tpu_torch.nn.layers.attention import MultiHeadAttention
from deeplearning4j_tpu_torch.nn.layers.base import Layer, layer_from_dict
from deeplearning4j_tpu_torch.nn.layers.convolution import (
    Convolution1DLayer,
    ConvolutionLayer,
    ConvolutionMode,
    PoolingMode,
    SeparableConvolution2D,
    SpaceToDepthLayer,
    Subsampling1DLayer,
    SubsamplingLayer,
    Upsampling1D,
    Upsampling2D,
    ZeroPadding1DLayer,
    ZeroPaddingLayer,
)
from deeplearning4j_tpu_torch.nn.layers.feedforward import (
    ActivationLayer,
    AutoEncoder,
    DenseLayer,
    DropoutLayer,
    EmbeddingLayer,
    LossLayer,
    OutputLayer,
)
from deeplearning4j_tpu_torch.nn.layers.misc import (
    FrozenLayer,
    PermuteLayer,
    PoolHelperLayer,
    ReshapeLayer,
)
from deeplearning4j_tpu_torch.nn.layers.moe import MixtureOfExperts
from deeplearning4j_tpu_torch.nn.layers.normalization import (
    BatchNormalization,
    LayerNormalization,
    LocalResponseNormalization,
    layer_norm_reference,
)
from deeplearning4j_tpu_torch.nn.layers.objdetect import (
    DetectedObject,
    Yolo2OutputLayer,
    non_max_suppression,
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
from deeplearning4j_tpu_torch.nn.layers.rbm import RBM, HiddenUnit, VisibleUnit
from deeplearning4j_tpu_torch.nn.layers.training import CenterLossOutputLayer
from deeplearning4j_tpu_torch.nn.layers.transformer import (
    PositionalEncodingLayer,
    TransformerEncoderBlock,
    stream_budget,
)
from deeplearning4j_tpu_torch.nn.layers.variational import (
    BernoulliReconstructionDistribution,
    ExponentialReconstructionDistribution,
    GaussianReconstructionDistribution,
    VariationalAutoencoder,
)

__all__ = ["ActivationLayer", "AutoEncoder", "BaseRecurrentLayer",
           "BatchNormalization", "BernoulliReconstructionDistribution",
           "CenterLossOutputLayer", "Convolution1DLayer", "ConvolutionLayer",
           "ConvolutionMode", "DenseLayer", "DetectedObject", "DropoutLayer",
           "EmbeddingLayer", "ExponentialReconstructionDistribution",
           "FrozenLayer", "GaussianReconstructionDistribution",
           "GlobalPoolingLayer", "GravesBidirectionalLSTM", "GravesLSTM",
           "HiddenUnit", "LSTM", "LastTimeStep", "Layer",
           "LayerNormalization", "LocalResponseNormalization", "LossLayer",
           "MixtureOfExperts", "MultiHeadAttention", "OutputLayer",
           "PermuteLayer", "PoolHelperLayer", "PoolingMode", "PoolingType",
           "PositionalEncodingLayer", "RBM", "ReshapeLayer",
           "RnnOutputLayer", "SeparableConvolution2D", "SimpleRnn",
           "SpaceToDepthLayer", "Subsampling1DLayer", "SubsamplingLayer",
           "TransformerEncoderBlock", "Upsampling1D", "Upsampling2D",
           "VariationalAutoencoder", "VisibleUnit", "Yolo2OutputLayer",
           "ZeroPadding1DLayer", "ZeroPaddingLayer", "layer_from_dict",
           "layer_norm_reference", "non_max_suppression", "stream_budget"]
