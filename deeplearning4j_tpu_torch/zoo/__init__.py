from deeplearning4j_tpu_torch.zoo.alexnet import AlexNet
from deeplearning4j_tpu_torch.zoo.base import PretrainedType, ZooModel
from deeplearning4j_tpu_torch.zoo.facenet import FaceNetNN4Small2
from deeplearning4j_tpu_torch.zoo.googlenet import GoogLeNet
from deeplearning4j_tpu_torch.zoo.inceptionresnet import InceptionResNetV1
from deeplearning4j_tpu_torch.zoo.lenet import LeNet
from deeplearning4j_tpu_torch.zoo.resnet50 import ResNet50
from deeplearning4j_tpu_torch.zoo.simplecnn import SimpleCNN
from deeplearning4j_tpu_torch.zoo.textgenlstm import TextGenerationLSTM
from deeplearning4j_tpu_torch.zoo.transformer import (
    TransformerClassifier,
    TransformerLM,
    generate,
)
from deeplearning4j_tpu_torch.zoo.vgg import VGG16, VGG19

__all__ = ["AlexNet", "FaceNetNN4Small2", "GoogLeNet", "InceptionResNetV1",
           "LeNet", "PretrainedType", "ResNet50", "SimpleCNN",
           "TextGenerationLSTM", "TransformerClassifier", "TransformerLM",
           "VGG16", "VGG19", "ZooModel", "generate"]
