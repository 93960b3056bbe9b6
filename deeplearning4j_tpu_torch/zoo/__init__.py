from deeplearning4j_tpu_torch.zoo.base import PretrainedType, ZooModel
from deeplearning4j_tpu_torch.zoo.resnet50 import ResNet50
from deeplearning4j_tpu_torch.zoo.textgenlstm import TextGenerationLSTM
from deeplearning4j_tpu_torch.zoo.transformer import (
    TransformerClassifier,
    TransformerLM,
    generate,
)

__all__ = ["PretrainedType", "ResNet50", "TextGenerationLSTM",
           "TransformerClassifier", "TransformerLM", "ZooModel", "generate"]
