"""The configuration DSL (counterpart of `deeplearning4j_tpu/nn/conf/`):
`builder.py` (NeuralNetConfiguration -> MultiLayerConfiguration),
`inputs.py`, and the serde of dropout, weight noise, constraints and
preprocessors. Configurations are data with the JAX package's JSON
form, so a `configuration.json` either package wrote builds the other's
network."""
