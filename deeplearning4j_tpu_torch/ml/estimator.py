"""Estimator/Transformer ML-pipeline adapters in the sklearn contract
(counterpart of `deeplearning4j_tpu/ml/estimator.py`).

Reference: `dl4j-spark-ml`'s `SparkDl4jNetwork.scala` (a Spark-ML
`Predictor` whose `train()` drives the distributed trainer) and
`AutoEncoder.scala` (an estimator whose model transforms rows into codes
or reconstructions). The adapters implement `fit` / `predict` /
`transform` / `get_params` / `set_params`, so they slot into
`sklearn.pipeline.Pipeline` and `GridSearchCV`. With scikit-learn
installed they derive from its `BaseEstimator` (`clone` and the tags
work); without it, from a base with the same parameter plumbing. Each
estimator trains on `device` (default ``"cuda"``); a `TrainingMaster`
fits the network over a mesh instead.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

try:
    # the real sklearn base when installed: get_params/set_params,
    # __sklearn_tags__, clone support
    from sklearn.base import BaseEstimator as _SklearnBase

    class _BaseEstimator(_SklearnBase):
        _param_names = ()

except ImportError:
    class _BaseEstimator:
        """Duck-typed parameter plumbing when sklearn is absent."""

        _param_names = ()

        def get_params(self, deep: bool = True):
            return {k: getattr(self, k) for k in self._param_names}

        def set_params(self, **params):
            for k, v in params.items():
                if k not in self._param_names:
                    raise ValueError(
                        f"Invalid parameter {k!r} for {type(self).__name__}")
                setattr(self, k, v)
            return self


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


class NetworkEstimator(_BaseEstimator):
    """`SparkDl4jNetwork`'s counterpart: an estimator around a network
    configuration; `fit(X, y)` trains on `device` (or through a
    TrainingMaster) and the fitted estimator's `predict` /
    `predict_proba` / `transform` run batched inference.

    `conf_factory`: () -> a MultiLayerConfiguration or a network (a
    ComputationGraph, say) — a factory, not an instance, so each `fit`
    starts from a fresh init (the sklearn clone contract)."""

    _param_names = ("conf_factory", "epochs", "batch_size",
                    "training_master", "num_classes", "steps_per_execution",
                    "device")

    def __init__(self, conf_factory: Callable, *, epochs: int = 10,
                 batch_size: int = 32, training_master=None,
                 num_classes: Optional[int] = None,
                 steps_per_execution: int = 1, device="cuda"):
        self.conf_factory = conf_factory
        self.epochs = epochs
        self.batch_size = batch_size
        self.training_master = training_master
        self.num_classes = num_classes
        self.steps_per_execution = steps_per_execution
        self.device = device
        self.model_ = None

    # ------------------------------------------------------------- fitting
    def _one_hot(self, y):
        y = np.asarray(y)
        if y.ndim == 1 or (y.ndim == 2 and y.shape[1] == 1):
            y = y.reshape(-1).astype(int)
            n = self.num_classes or int(y.max()) + 1
            self.classes_ = np.arange(n)
            return np.eye(n, dtype=np.float32)[y]
        self.classes_ = np.arange(y.shape[1])
        return y.astype(np.float32)

    def fit(self, X, y):
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        conf = self.conf_factory()
        net = (conf if hasattr(conf, "fit")
               else MultiLayerNetwork(conf, device=self.device))
        net.init()
        X = np.asarray(X, np.float32)
        y1h = self._one_hot(y)
        if self.training_master is not None:
            self.training_master.execute_training(net, (X, y1h),
                                                  epochs=self.epochs)
        else:
            net.fit(X, y1h, epochs=self.epochs, batch_size=self.batch_size,
                    steps_per_execution=self.steps_per_execution)
        self.model_ = net
        return self

    # ----------------------------------------------------------- inference
    def _check_fitted(self):
        if self.model_ is None:
            raise RuntimeError("Estimator is not fitted; call fit(X, y) first")

    def predict_proba(self, X):
        self._check_fitted()
        return _host(self.model_.output(np.asarray(X, np.float32)))

    def predict(self, X):
        return self.predict_proba(X).argmax(axis=-1)

    def transform(self, X):
        """The Transformer view: the output activations (reference
        `SparkDl4jModel.transform`'s output column)."""
        return self.predict_proba(X)

    def score(self, X, y):
        """Mean accuracy (the sklearn classifier contract)."""
        y = np.asarray(y)
        if y.ndim > 1:
            y = y.argmax(axis=-1)
        return float((self.predict(X) == y).mean())


class AutoEncoderEstimator(_BaseEstimator):
    """`dl4j-spark-ml AutoEncoder.scala`'s counterpart: `fit(X)`
    pretrains an AutoEncoder layer on `device` and `transform` emits the
    hidden code (or the reconstruction)."""

    _param_names = ("n_hidden", "epochs", "batch_size", "learning_rate",
                    "corruption_level", "output", "device")

    def __init__(self, n_hidden: int, *, epochs: int = 10,
                 batch_size: int = 32, learning_rate: float = 1e-2,
                 corruption_level: float = 0.0, output: str = "code",
                 device="cuda"):
        if output not in ("code", "reconstruction"):
            raise ValueError("output must be 'code' or 'reconstruction'")
        self.n_hidden = n_hidden
        self.epochs = epochs
        self.batch_size = batch_size
        self.learning_rate = learning_rate
        self.corruption_level = corruption_level
        self.output = output
        self.device = device
        self.model_ = None

    def fit(self, X, y=None):
        from deeplearning4j_tpu_torch.common.updaters import Adam
        from deeplearning4j_tpu_torch.nn.conf.builder import (
            NeuralNetConfiguration)
        from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
        from deeplearning4j_tpu_torch.nn.layers import AutoEncoder, OutputLayer
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        X = np.asarray(X, np.float32)
        n_in = X.shape[-1]
        conf = (NeuralNetConfiguration.builder()
                .seed(12).updater(Adam(self.learning_rate))
                .list()
                .layer(AutoEncoder(n_in=n_in, n_out=self.n_hidden,
                                   corruption_level=self.corruption_level,
                                   activation="sigmoid"))
                .layer(OutputLayer(n_in=self.n_hidden, n_out=n_in,
                                   activation="identity", loss="mse"))
                .set_input_type(InputType.feed_forward(n_in))
                .build())
        net = MultiLayerNetwork(conf, device=self.device).init()
        net.pretrain(X, epochs=self.epochs, batch_size=self.batch_size)
        self.model_ = net
        self._layer = net.layers[0]
        return self

    def transform(self, X):
        import torch
        if self.model_ is None:
            raise RuntimeError("Estimator is not fitted; call fit(X) first")
        x = torch.as_tensor(np.asarray(X, np.float32),
                            device=self.model_.device)
        with torch.no_grad():
            code = self._layer.encode(x)
            out = code if self.output == "code" else self._layer.decode(code)
        return _host(out)

    def fit_transform(self, X, y=None):
        return self.fit(X).transform(X)
