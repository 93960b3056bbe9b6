from deeplearning4j_tpu_torch.zoo.transformer import (
    TransformerClassifier,
    TransformerLM,
    generate,
)

__all__ = ["TransformerClassifier", "TransformerLM", "generate"]
