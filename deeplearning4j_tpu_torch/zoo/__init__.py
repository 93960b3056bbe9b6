from deeplearning4j_tpu_torch.zoo.transformer import TransformerLM, generate

__all__ = ["TransformerLM", "generate"]
