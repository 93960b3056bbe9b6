"""KerasModelImport: Keras 1, 2 and 3 `.h5` files into the port's
networks (counterpart of `deeplearning4j_tpu/modelimport/keras.py`).

The mapping is the JAX package's, class for class and field for field:
`KerasLayerMapper` turns each Keras layer dict into the port's layer
configurations (Keras 1 and Keras 2 spellings), `training_config` gives
the updater and the loss (a compiled model's trailing Dense becomes an
`OutputLayer`), and the weights land in exactly the shapes JAX's
importer gives them:

- a Dense kernel [in, out] is "W" as it is;
- a Conv2D kernel [kh, kw, in, out] is the HWIO "W" as it is (the
  port's tensor keeps that shape over channels_last memory); a Keras 1
  Theano kernel [out, in, kh, kw] is transposed and flipped;
- LSTM kernels are reordered from Keras's i, f, c, o gates to the
  framework's i, f, o, g;
- BatchNormalization's gamma and beta are params, its moving mean and
  variance the layer's running state.

The HDF5 side is host work through `Hdf5Archive`; every entry point
that returns a network builds it on `device` (default ``"cuda"``,
resolved by `device.resolve_device`) and copies the weights there.
"""

from __future__ import annotations

import json
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.common.updaters import Adam
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.modelimport.hdf5 import HDF5_MAGIC, Hdf5Archive
from deeplearning4j_tpu_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph import (
    ElementWiseVertex,
    MergeVertex,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    CnnToFeedForwardPreProcessor,
)
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph,
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers import (
    LSTM,
    ActivationLayer,
    BatchNormalization,
    Convolution1DLayer,
    ConvolutionLayer,
    DenseLayer,
    DropoutLayer,
    EmbeddingLayer,
    GlobalPoolingLayer,
    LastTimeStep,
    LocalResponseNormalization,
    LossLayer,
    OutputLayer,
    PermuteLayer,
    PoolHelperLayer,
    ReshapeLayer,
    SeparableConvolution2D,
    SimpleRnn,
    Subsampling1DLayer,
    SubsamplingLayer,
    Upsampling1D,
    Upsampling2D,
    ZeroPadding1DLayer,
    ZeroPaddingLayer,
)
from deeplearning4j_tpu_torch.nn.layers.convolution import (
    ConvolutionMode,
    PoolingMode,
)
from deeplearning4j_tpu_torch.nn.layers.pooling import PoolingType
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

_ACTIVATIONS = {
    "relu": "relu", "sigmoid": "sigmoid", "tanh": "tanh", "softmax": "softmax",
    "linear": "identity", "softplus": "softplus", "softsign": "softsign",
    "elu": "elu", "selu": "selu", "hard_sigmoid": "hardsigmoid",
    "swish": "swish", "gelu": "gelu", "relu6": "relu6",
}


def _act(name):
    if name is None:
        return "identity"
    return _ACTIVATIONS.get(name, name)


def _conv_mode(cfg):
    # Keras 2 "padding" / Keras 1 "border_mode"
    pad = cfg.get("padding", cfg.get("border_mode", "valid"))
    return ConvolutionMode.SAME if pad == "same" else ConvolutionMode.TRUNCATE


def _pair(v, default=(1, 1)):
    if v is None:
        return default
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v), int(v))


def _first(v):
    return v[0] if isinstance(v, (list, tuple)) else v


class KerasLayerMapper:
    """One Keras layer dict -> zero or more of the port's layers.

    Handles both dialects: Keras 1 (`output_dim`, `nb_filter`,
    `nb_row/nb_col`, `subsample`, `border_mode`, `init`) and Keras 2
    (`units`, `filters`, `kernel_size`, `strides`, `padding`)."""

    def map(self, class_name: str, cfg: dict) -> List:
        m = getattr(self, f"_map_{class_name.lower()}", None)
        if m is None:
            raise ValueError(f"Unsupported Keras layer: {class_name}")
        out = m(cfg)
        return out if isinstance(out, list) else [out]

    # ---- core ----
    def _units(self, cfg):
        return int(cfg.get("units", cfg.get("output_dim", 0)))

    def _map_dense(self, cfg):
        return DenseLayer(n_out=self._units(cfg),
                          activation=_act(cfg.get("activation")),
                          has_bias=cfg.get("use_bias", cfg.get("bias", True)),
                          name=cfg.get("name"))

    def _map_activation(self, cfg):
        return ActivationLayer(activation=_act(cfg.get("activation")),
                               name=cfg.get("name"))

    def _map_leakyrelu(self, cfg):
        # Keras 1/2 "alpha", Keras 3 "negative_slope"; default 0.3
        alpha = cfg.get("negative_slope", cfg.get("alpha", 0.3))
        return ActivationLayer(activation=f"leakyrelu:{alpha}",
                               name=cfg.get("name"))

    def _map_dropout(self, cfg):
        # Keras rate = the DROP fraction; the framework's = RETAIN prob
        rate = cfg.get("rate", cfg.get("p", 0.5))
        return DropoutLayer(dropout=1.0 - float(rate), name=cfg.get("name"))

    def _map_flatten(self, cfg):
        return []  # the automatic CNN -> FF preprocessor does this

    def _map_masking(self, cfg):
        return []  # masks are explicit in the fit/eval API

    # ---- conv ----
    def _kernel2d(self, cfg):
        return _pair(cfg.get("kernel_size",
                             (cfg.get("nb_row"), cfg.get("nb_col"))
                             if cfg.get("nb_row") else None), (3, 3))

    def _map_conv2d(self, cfg):
        return ConvolutionLayer(
            n_out=int(cfg.get("filters", cfg.get("nb_filter", 0))),
            kernel_size=self._kernel2d(cfg),
            stride=_pair(cfg.get("strides", cfg.get("subsample"))),
            dilation=_pair(cfg.get("dilation_rate",
                                   cfg.get("atrous_rate", (1, 1)))),
            convolution_mode=_conv_mode(cfg),
            activation=_act(cfg.get("activation")),
            has_bias=cfg.get("use_bias", cfg.get("bias", True)),
            name=cfg.get("name"))

    _map_convolution2d = _map_conv2d  # Keras 1 name

    def _map_conv1d(self, cfg):
        k = _first(cfg.get("kernel_size", cfg.get("filter_length", 3)))
        s = _first(cfg.get("strides", cfg.get("subsample_length", 1)))
        d = _first(cfg.get("dilation_rate", cfg.get("atrous_rate", 1)))
        return Convolution1DLayer(
            n_out=int(cfg.get("filters", cfg.get("nb_filter", 0))),
            kernel_size=int(k), stride=int(s), dilation=(int(d), 1),
            convolution_mode=_conv_mode(cfg),
            activation=_act(cfg.get("activation")),
            name=cfg.get("name"))

    _map_convolution1d = _map_conv1d

    def _map_maxpooling2d(self, cfg):
        return SubsamplingLayer(
            pooling_type=PoolingMode.MAX,
            kernel_size=_pair(cfg.get("pool_size"), (2, 2)),
            stride=_pair(cfg.get("strides", cfg.get("pool_size")), (2, 2)),
            convolution_mode=_conv_mode(cfg), name=cfg.get("name"))

    def _map_averagepooling2d(self, cfg):
        layer = self._map_maxpooling2d(cfg)
        layer.pooling_type = PoolingMode.AVG
        return layer

    def _map_maxpooling1d(self, cfg):
        k = _first(cfg.get("pool_size", cfg.get("pool_length", 2)))
        s = _first(cfg.get("strides", cfg.get("stride")) or k)
        return Subsampling1DLayer(kernel_size=int(k), stride=int(s),
                                  convolution_mode=_conv_mode(cfg),
                                  name=cfg.get("name"))

    def _map_averagepooling1d(self, cfg):
        layer = self._map_maxpooling1d(cfg)
        layer.pooling_type = PoolingMode.AVG
        return layer

    def _map_globalmaxpooling2d(self, cfg):
        return GlobalPoolingLayer(pooling_type=PoolingType.MAX,
                                  name=cfg.get("name"))

    def _map_globalaveragepooling2d(self, cfg):
        return GlobalPoolingLayer(pooling_type=PoolingType.AVG,
                                  name=cfg.get("name"))

    _map_globalmaxpooling1d = _map_globalmaxpooling2d
    _map_globalaveragepooling1d = _map_globalaveragepooling2d

    def _map_zeropadding2d(self, cfg):
        pad = cfg.get("padding", 1)
        return ZeroPaddingLayer(pad=pad if isinstance(pad, int) else tuple(
            tuple(p) if isinstance(p, (list, tuple)) else (p, p)
            for p in pad), name=cfg.get("name"))

    def _map_upsampling2d(self, cfg):
        return Upsampling2D(size=_pair(cfg.get("size"), (2, 2)),
                            name=cfg.get("name"))

    # ---- recurrent / embedding ----
    def _map_embedding(self, cfg):
        return EmbeddingLayer(n_in=int(cfg.get("input_dim", 0)),
                              n_out=int(cfg.get("output_dim", 0)),
                              has_bias=False, name=cfg.get("name"))

    def _map_lstm(self, cfg):
        # Keras 2 defaults to hard_sigmoid gates, Keras 3 writes sigmoid:
        # the file's config says which
        layers = [LSTM(n_out=self._units(cfg),
                       activation=_act(cfg.get("activation", "tanh")),
                       gate_activation=_act(cfg.get(
                           "recurrent_activation",
                           cfg.get("inner_activation", "hard_sigmoid"))),
                       name=cfg.get("name"))]
        if not cfg.get("return_sequences", False):
            layers.append(LastTimeStep())
        return layers

    def _map_simplernn(self, cfg):
        layers = [SimpleRnn(n_out=self._units(cfg),
                            activation=_act(cfg.get("activation", "tanh")),
                            name=cfg.get("name"))]
        if not cfg.get("return_sequences", False):
            layers.append(LastTimeStep())
        return layers

    # ---- normalization ----
    def _map_batchnormalization(self, cfg):
        # keras-applications' ResNet-50 uses epsilon 1.001e-5: always the
        # layer's own value
        return BatchNormalization(eps=float(cfg.get("epsilon", 1e-3)),
                                  decay=float(cfg.get("momentum", 0.99)),
                                  name=cfg.get("name"))

    def _map_lrn(self, cfg):
        # a custom layer of Theano-era zoo files (reference KerasLRN)
        return LocalResponseNormalization(
            k=float(cfg.get("k", 2.0)), n=int(cfg.get("n", 5)),
            alpha=float(cfg.get("alpha", 1e-4)),
            beta=float(cfg.get("beta", 0.75)), name=cfg.get("name"))

    _map_localresponsenormalization = _map_lrn

    # ---- shape ops ----
    def _map_reshape(self, cfg):
        return ReshapeLayer(target_shape=tuple(cfg.get("target_shape", ())),
                            name=cfg.get("name"))

    def _map_permute(self, cfg):
        return PermuteLayer(dims=tuple(cfg.get("dims", ())),
                            name=cfg.get("name"))

    def _map_poolhelper(self, cfg):
        # a custom layer of Theano-era GoogLeNet files (KerasPoolHelper)
        return PoolHelperLayer(name=cfg.get("name"))

    def _map_zeropadding1d(self, cfg):
        pad = cfg.get("padding", 1)
        if isinstance(pad, (list, tuple)):
            pad = tuple(int(p) for p in pad)
        return ZeroPadding1DLayer(pad=pad, name=cfg.get("name"))

    def _map_upsampling1d(self, cfg):
        s = cfg.get("size", cfg.get("length", 2))
        return Upsampling1D(size=int(_first(s)), name=cfg.get("name"))

    # ---- dilated + separable conv ----
    # Keras 1 Atrous* classes: the base mappers read atrous_rate
    _map_atrousconvolution2d = _map_conv2d
    _map_atrousconvolution1d = _map_conv1d

    def _map_separableconv2d(self, cfg):
        return SeparableConvolution2D(
            n_out=int(cfg.get("filters", cfg.get("nb_filter", 0))),
            kernel_size=self._kernel2d(cfg),
            stride=_pair(cfg.get("strides", cfg.get("subsample"))),
            dilation=_pair(cfg.get("dilation_rate", (1, 1))),
            depth_multiplier=int(cfg.get("depth_multiplier", 1)),
            convolution_mode=_conv_mode(cfg),
            activation=_act(cfg.get("activation")),
            has_bias=cfg.get("use_bias", cfg.get("bias", True)),
            name=cfg.get("name"))

    _map_separableconvolution2d = _map_separableconv2d  # Keras 1 name


# Keras loss identifier -> the framework's loss name (KerasLoss.java).
_KERAS_LOSSES = {
    "categorical_crossentropy": "mcxent",
    "sparse_categorical_crossentropy": "mcxent",
    "binary_crossentropy": "xent",
    "mean_squared_error": "mse", "mse": "mse",
    "mean_absolute_error": "mae", "mae": "mae",
    "mean_squared_logarithmic_error": "msle", "msle": "msle",
    "kullback_leibler_divergence": "kl_divergence", "kld": "kl_divergence",
    "kl_divergence": "kl_divergence", "kldivergence": "kl_divergence",
    "poisson": "poisson",
    "cosine_similarity": "cosine_proximity",
    "cosine_proximity": "cosine_proximity",
    "hinge": "hinge", "squared_hinge": "squaredhinge",
}


def _updater_from_training_config(tc: dict):
    """Keras optimizer_config -> the framework's updater. Unknown
    optimizers fall back to Adam, as JAX's importer does."""
    from deeplearning4j_tpu_torch.common.updaters import (
        AdaGrad, Nesterovs, RmsProp, Sgd,
    )
    oc = tc.get("optimizer_config") or {}
    cname = oc.get("class_name", "")
    cfg = oc.get("config", {})
    lr = float(cfg.get("learning_rate", cfg.get("lr", 1e-3)))
    if cname in ("SGD", "Sgd"):
        mom = float(cfg.get("momentum", 0.0))
        return Nesterovs(lr, momentum=mom) if mom else Sgd(lr)
    if cname in ("RMSprop", "RMSProp"):
        return RmsProp(lr, rho=float(cfg.get("rho", 0.9)))
    if cname == "Adagrad":
        return AdaGrad(lr)
    if cname == "Adam":
        return Adam(lr, beta1=float(cfg.get("beta_1", 0.9)),
                    beta2=float(cfg.get("beta_2", 0.999)))
    return Adam(lr)


class KerasModelImport:
    """The entry points of `KerasModelImport.java`."""

    # ------------------------------------------------------------ public
    @staticmethod
    def import_keras_model_and_weights(path, enforce_training_config=False,
                                       *, device="cuda"):
        """A full Keras model file (`model_config`, weights and, when
        compiled, `training_config`) as a MultiLayerNetwork (Sequential)
        or a ComputationGraph on `device`."""
        device = resolve_device(device)
        with Hdf5Archive(path) as h5:
            config = h5.read_attr_string("model_config")
            if config is None:
                raise ValueError(f"{path}: no model_config attribute")
            model_dict = json.loads(config)
            tc_str = h5.read_attr_string("training_config")
            training_config = json.loads(tc_str) if tc_str else None
            if enforce_training_config and training_config is None:
                raise ValueError(
                    f"{path}: model was saved uncompiled (no "
                    f"training_config) but enforce_training_config=True")
            return KerasModelImport._import(model_dict, h5, training_config,
                                            device)

    @staticmethod
    def import_keras_sequential_model_and_weights(path, *, device="cuda",
                                                  **kw):
        model = KerasModelImport.import_keras_model_and_weights(
            path, device=device, **kw)
        if not isinstance(model, MultiLayerNetwork):
            raise ValueError("Not a Sequential model")
        return model

    @staticmethod
    def import_keras_configuration(path):
        """Architecture only, no weights (reference
        `importKerasModelConfiguration`): a bare `model.to_json()` file or
        an .h5 whose `model_config` attribute is read; returns the mapped
        configuration."""
        with open(path, "rb") as f:
            magic = f.read(8)
        if magic == HDF5_MAGIC:
            with Hdf5Archive(path) as h5:
                config = h5.read_attr_string("model_config")
                if config is None:
                    raise ValueError(f"{path}: no model_config attribute")
                model_dict = json.loads(config)
        else:
            with open(path, "r", errors="replace") as f:
                model_dict = json.loads(f.read())
        return KerasModelImport.config_from_dict(model_dict)

    @staticmethod
    def import_architecture_and_weights(arch, weights_path, *,
                                        device="cuda"):
        """Architecture JSON (a file path or a dict) and a separate
        weights-only .h5 (the keras-applications split: `model.to_json()`
        beside `save_weights`). The weights are copied BY KERAS LAYER
        NAME, whatever the file's layer order."""
        device = resolve_device(device)
        if isinstance(arch, (str, bytes)) or hasattr(arch, "__fspath__"):
            with open(arch, "r") as f:
                model_dict = json.loads(f.read())
        else:
            model_dict = arch
        with Hdf5Archive(weights_path) as h5:
            return KerasModelImport._import(model_dict, h5, None, device)

    @staticmethod
    def config_from_dict(model_dict, training_config=None):
        """Keras architecture dict -> the port's configuration (the
        config-only half of the import: the same mapping, no net)."""
        return KerasModelImport._conf(model_dict, None, training_config)[0]

    @staticmethod
    def _conf(model_dict, h5, training_config):
        """(configuration, [(keras layer name, our key)])."""
        if model_dict.get("class_name") == "Sequential":
            return KerasModelImport._sequential_conf(model_dict, h5,
                                                     training_config)
        return KerasModelImport._functional_conf(model_dict, h5,
                                                 training_config)

    @staticmethod
    def _import(model_dict, h5, training_config, device):
        """The network of `model_dict` on `device`, its params drawn from
        the configuration's seed, then each weighted Keras layer that
        `h5` holds copied in."""
        conf, keras_names = KerasModelImport._conf(model_dict, h5,
                                                   training_config)
        cls = (ComputationGraph
               if isinstance(conf, ComputationGraphConfiguration)
               else MultiLayerNetwork)
        net = cls(conf, device=device).init()
        KerasModelImport._copy_weights(net, h5, keras_names)
        return net

    # -------------------------------------------------------- sequential
    @staticmethod
    def _layer_list(model_dict):
        cfg = model_dict["config"]
        if isinstance(cfg, dict):   # Keras 2.2+: {"name":..., "layers":[...]}
            return cfg["layers"]
        return cfg                   # Keras 1 / early 2: [...]

    @staticmethod
    def _input_type_from(layer_cfgs):
        first = layer_cfgs[0]["config"]
        # Keras 1/2: batch_input_shape; Keras 3 InputLayer: batch_shape
        shape = first.get("batch_input_shape", first.get("batch_shape"))
        if shape is not None:
            dims = list(shape[1:])
            if len(dims) == 3:   # [H, W, C] (channels_last)
                return InputType.convolutional(dims[0], dims[1], dims[2])
            if len(dims) == 2:   # [T, F]
                return InputType.recurrent(dims[1], dims[0])
            if len(dims) == 1:
                return InputType.feed_forward(dims[0])
        if "input_dim" in first and first.get("input_length"):
            return InputType.recurrent(first["input_dim"],
                                       first["input_length"])
        if "input_dim" in first:
            return InputType.feed_forward(first["input_dim"])
        raise ValueError("Cannot infer input shape from Keras config")

    @staticmethod
    def _channels_last(model_dict, h5) -> bool:
        """TF-backend Keras flattens NHWC; Theano-era (Keras 1) files
        flatten channel-major. Priority: an explicit per-layer
        dim_ordering ("th"/"tf") > the file's backend attr > the config
        shape (a Keras 1 Sequential config is a list)."""
        cfg = model_dict.get("config")
        layer_list = cfg.get("layers", []) if isinstance(cfg, dict) else cfg
        for lc in layer_list or []:
            ordering = (lc.get("config") or {}).get("dim_ordering")
            if ordering in ("th", "tf"):
                return ordering == "tf"
        backend = h5.read_attr_string("backend") if h5 is not None else None
        if backend:
            return backend == "tensorflow"
        return (model_dict.get("class_name") != "Sequential"
                or isinstance(cfg, dict))

    @staticmethod
    def _fix_flatten_order(preprocessors, channels_last: bool):
        if channels_last:
            for pp in preprocessors:
                if isinstance(pp, CnnToFeedForwardPreProcessor):
                    pp.data_format = "nhwc"

    @staticmethod
    def _loss_name(training_config) -> Optional[str]:
        if not training_config:
            return None
        loss = training_config.get("loss")
        if isinstance(loss, (list, tuple)) and loss:
            loss = loss[0]
        elif (isinstance(loss, dict) and loss
              and "class_name" not in loss):  # {output_name: loss} map
            loss = next(iter(loss.values()))
        if isinstance(loss, (list, tuple)) and loss:
            loss = loss[0]
        if isinstance(loss, dict):  # a serialized loss object
            loss = ((loss.get("config") or {}).get("name")
                    or loss.get("class_name"))
        if not isinstance(loss, str):
            return None
        # CamelCase class names -> snake identifiers
        # (CategoricalCrossentropy -> categorical_crossentropy)
        key = loss.lower()
        if key not in _KERAS_LOSSES:
            key = re.sub(r"(?<=[a-z0-9])(?=[A-Z])", "_", loss).lower()
        return _KERAS_LOSSES.get(key)

    @staticmethod
    def _to_output_layer(dense, loss) -> OutputLayer:
        return OutputLayer(n_out=dense.n_out, activation=dense.activation,
                           has_bias=dense.has_bias, name=dense.name,
                           loss=loss)

    @staticmethod
    def _sequential_conf(model_dict, h5, training_config=None):
        layer_cfgs = KerasModelImport._layer_list(model_dict)
        mapper = KerasLayerMapper()
        updater = (_updater_from_training_config(training_config)
                   if training_config else Adam(1e-3))
        loss = KerasModelImport._loss_name(training_config)
        keras_names: List[Tuple[str, str]] = []  # (keras name, our key)
        mapped_all: List = []
        for lc in layer_cfgs:
            cname = lc["class_name"]
            if cname == "InputLayer":
                continue
            mapped = mapper.map(cname, lc["config"])
            for mi, layer in enumerate(mapped):
                if mi == 0 and not isinstance(layer, LastTimeStep):
                    keras_names.append((lc["config"].get("name", cname),
                                        str(len(mapped_all))))
                mapped_all.append(layer)
        # a compiled model carries its loss in training_config: a
        # trailing Dense becomes an OutputLayer so the import can fit()
        if loss is not None and mapped_all:
            if type(mapped_all[-1]) is DenseLayer:
                mapped_all[-1] = KerasModelImport._to_output_layer(
                    mapped_all[-1], loss)
            else:
                mapped_all.append(LossLayer(loss=loss))
        builder = NeuralNetConfiguration.builder().updater(updater).list()
        for layer in mapped_all:
            builder.layer(layer)
        builder.set_input_type(KerasModelImport._input_type_from(layer_cfgs))
        conf = builder.build()
        KerasModelImport._fix_flatten_order(
            conf.input_preprocessors.values(),
            KerasModelImport._channels_last(model_dict, h5))
        return conf, keras_names

    # -------------------------------------------------------- functional
    @staticmethod
    def _boundary_names(spec) -> List[str]:
        """input_layers/output_layers -> layer names. Keras 1/2:
        [["name", 0, 0], ...]; Keras 3 single-tensor models flatten to
        one ["name", 0, 0]; plain strings pass through."""
        if not spec:
            return []
        if (isinstance(spec, list) and isinstance(spec[0], str)
                and any(isinstance(x, int) for x in spec)):
            return [spec[0]]  # flat ["name", 0, 0]
        return [s[0] if isinstance(s, list) else s for s in spec]

    @staticmethod
    def _inbound_sources(inbound) -> List[str]:
        """The first inbound node -> its source layer names. Keras 1/2:
        [[["src", 0, 0, {}], ...]]; Keras 3: [{"args":
        [<__keras_tensor__> | [<__keras_tensor__>, ...]], "kwargs": {}}]
        with keras_history naming the source."""
        if not inbound:
            return []
        node = inbound[0]
        entries = node if isinstance(node, list) else node.get("args", [])
        srcs: List[str] = []

        def walk(e):
            if isinstance(e, dict):
                if e.get("class_name") == "__keras_tensor__":
                    srcs.append(e["config"]["keras_history"][0])
            elif isinstance(e, list):
                if e and isinstance(e[0], str):
                    srcs.append(e[0])      # ["src", 0, 0, {...}]
                else:
                    for x in e:
                        walk(x)
            elif isinstance(e, str):
                srcs.append(e)
        for e in entries:
            walk(e)
        return srcs

    @staticmethod
    def _input_type_of(shape):
        dims = shape[1:]
        if len(dims) == 3:
            return InputType.convolutional(*dims)
        if len(dims) == 2:
            return InputType.recurrent(dims[1], dims[0])
        return InputType.feed_forward(dims[0])

    @staticmethod
    def _functional_conf(model_dict, h5, training_config=None):
        cfg = model_dict["config"]
        mapper = KerasLayerMapper()
        updater = (_updater_from_training_config(training_config)
                   if training_config else Adam(1e-3))
        loss = KerasModelImport._loss_name(training_config)
        g = ComputationGraphConfiguration.graph_builder(
            NeuralNetConfiguration.builder().updater(updater))
        input_names = KerasModelImport._boundary_names(
            cfg.get("input_layers", []))
        output_names = KerasModelImport._boundary_names(
            cfg.get("output_layers", []))
        g.add_inputs(*input_names)
        input_types = []
        keras_names: List[Tuple[str, str]] = []
        alias: Dict[str, str] = {}  # keras name -> the node producing it
        for lc in cfg["layers"]:
            cname = lc["class_name"]
            name = lc.get("name", lc["config"].get("name"))
            srcs = [alias.get(s, s) for s in KerasModelImport
                    ._inbound_sources(lc.get("inbound_nodes", []))]
            if cname == "InputLayer":
                input_types.append(KerasModelImport._input_type_of(
                    lc["config"].get("batch_input_shape",
                                     lc["config"].get("batch_shape"))))
                alias[name] = name
                continue
            mode = lc["config"].get("mode", "sum")
            if cname == "Add" or (cname == "Merge" and mode in ("sum", None)):
                g.add_vertex(name, ElementWiseVertex(op="add"), *srcs)
                alias[name] = name
                continue
            if cname == "Concatenate" or (cname == "Merge"
                                          and mode == "concat"):
                g.add_vertex(name, MergeVertex(), *srcs)
                alias[name] = name
                continue
            mapped = mapper.map(cname, lc["config"])
            if not mapped:  # Flatten/Masking: pass-through to the source
                alias[name] = srcs[0]
                continue
            if (loss is not None and name in output_names
                    and type(mapped[-1]) is DenseLayer):
                mapped[-1] = KerasModelImport._to_output_layer(mapped[-1],
                                                               loss)
            prev = srcs
            for mi, layer in enumerate(mapped):
                lname = name if mi == 0 else f"{name}_{mi}"
                if mi == 0:
                    keras_names.append((name, lname))
                g.add_layer(lname, layer, *prev)
                prev = [lname]
            alias[name] = prev[0]  # downstream refs see the LAST layer
        g.set_input_types(*input_types)
        g.set_outputs(*[alias.get(n, n) for n in output_names])
        conf = g.build()
        KerasModelImport._fix_flatten_order(
            [n.preprocessor for n in conf.nodes.values()
             if n.preprocessor is not None],
            KerasModelImport._channels_last(model_dict, h5))
        return conf, keras_names

    # ----------------------------------------------------- weights-only h5
    @staticmethod
    def load_weights_into(net, path):
        """Copy a weights-only Keras .h5 (`model.save_weights` output, no
        model_config; the keras-applications format) into an already
        built network, on its device.

        Keras stores layers in creation order under `layer_names`: the
        weighted layers are matched IN ORDER against the network's, each
        tensor shape-checked (a topology drift raises instead of
        corrupting params). A Keras 3 `.weights.h5` is matched by name
        (`_load_weights_into_k3`)."""
        with Hdf5Archive(path) as h5:
            if (h5.exists("/layers")
                    and not h5.read_attr_strings("layer_names")):
                return KerasModelImport._load_weights_into_k3(net, h5, path)
            root = KerasModelImport._weights_root(h5)
            keras_weighted = []
            for ln in h5.read_attr_strings("layer_names", root):
                kw = KerasModelImport._layer_weights(h5, root, ln)
                if kw:
                    keras_weighted.append((ln, kw))
            ours = KerasModelImport._weighted_layers(net)
            if len(keras_weighted) != len(ours):
                raise ValueError(
                    f"{path}: {len(keras_weighted)} weighted Keras layers "
                    f"vs {len(ours)} in the target network — topologies "
                    f"differ")
            for (kname, kw), (key, layer) in zip(keras_weighted, ours):
                KerasModelImport._apply_weights(layer, kw, kname)
        net.params_changed()
        return net

    # Positional var -> semantic-name tables of the Keras 3 .weights.h5
    # layout (layers/<slug>/vars/<i>; order = keras layer.weights order).
    _K3_VAR_NAMES = {
        "DenseLayer": ("kernel", "bias"),
        "OutputLayer": ("kernel", "bias"),
        "ConvolutionLayer": ("kernel", "bias"),
        "Convolution1DLayer": ("kernel", "bias"),
        "SeparableConvolution2D": ("depthwise_kernel", "pointwise_kernel",
                                   "bias"),
        "EmbeddingLayer": ("embeddings",),
        "LSTM": ("kernel", "recurrent_kernel", "bias"),
        "GravesLSTM": ("kernel", "recurrent_kernel", "bias"),
        "SimpleRnn": ("kernel", "recurrent_kernel", "bias"),
        "BatchNormalization": ("gamma", "beta", "moving_mean",
                               "moving_variance"),
    }

    @staticmethod
    def _load_weights_into_k3(net, h5, path):
        """Keras 3 .weights.h5: datasets at layers/<slug>/vars/<i>, the
        layer's name in the vars group's `name` attr. The file keeps no
        creation order, so layers are matched BY NAME (imported nets
        keep the Keras layer names)."""
        by_name: Dict[str, List[np.ndarray]] = {}
        for slug in h5.list_children("/layers"):
            vpath = f"/layers/{slug}/vars"
            if not h5.exists(vpath):
                continue
            idxs = sorted(h5.list_children(vpath), key=int)
            if not idxs:
                continue
            lname = h5.read_attr_string("name", vpath) or slug
            by_name[lname] = [h5.read_dataset(f"{vpath}/{i}") for i in idxs]
        ours = KerasModelImport._weighted_layers(net)
        unmatched = [getattr(l, "name", None) for _, l in ours
                     if getattr(l, "name", None) not in by_name]
        if unmatched:
            raise ValueError(
                f"{path}: weighted layers {unmatched} have no same-named "
                f"entry in the file (stored: {sorted(by_name)}) — "
                f"topologies differ")
        for _, layer in ours:
            arrays = by_name[layer.name]
            cls = type(layer).__name__
            names = KerasModelImport._K3_VAR_NAMES.get(cls)
            if names is None:
                raise ValueError(
                    f"{path}: no Keras-3 var-name table for {cls}")
            if len(arrays) != len(names):
                # positional assignment is safe only when the counts
                # agree (BatchNorm(scale=False) stores 3 vars)
                raise ValueError(
                    f"{path}: layer {layer.name} stores {len(arrays)} "
                    f"variables but {cls} expects {len(names)} ({names}) "
                    f"— cannot match positionally")
            KerasModelImport._apply_weights(layer, dict(zip(names, arrays)),
                                            layer.name)
        net.params_changed()
        return net

    @staticmethod
    def _weighted_layers(net):
        """(key, layer) of every layer holding params, in network order
        (a graph's keys are in its topological order)."""
        return [(key, layer) for key, layer in net.keyed()
                if layer.jax_param_map()]

    # ----------------------------------------------------------- weights
    @staticmethod
    def _weights_root(h5) -> str:
        return "/model_weights" if h5.exists("/model_weights") else "/"

    @staticmethod
    def _layer_weights(h5, root: str, lname: str) -> Dict[str, np.ndarray]:
        gpath = f"{root}/{lname}".replace("//", "/")
        out = {}
        for wn in h5.read_attr_strings("weight_names", gpath):
            short = wn.split("/")[-1].split(":")[0]
            # Keras 1 prefixes the layer name ("dense_1_W" -> "W",
            # "lstm_1_W_i" -> "W_i")
            if short.startswith(lname + "_"):
                short = short[len(lname) + 1:]
            out[short] = h5.read_dataset(f"{gpath}/{wn}".replace("//", "/"))
        return out

    @staticmethod
    def _convert(layer, kw: Dict[str, np.ndarray]) -> Tuple[Dict, Dict]:
        """Keras weights -> (params, state) of one layer, in JAX's names
        and shapes."""
        params, state = {}, {}
        cls = type(layer).__name__

        def bias():
            if "bias" in kw or "b" in kw:
                params["b"] = kw.get("bias", kw.get("b"))

        if cls in ("DenseLayer", "OutputLayer"):
            params["W"] = kw.get("kernel", kw.get("W"))
            bias()
        elif cls in ("ConvolutionLayer", "Convolution1DLayer"):
            k = kw.get("kernel", kw.get("W"))
            if k is not None and k.ndim == 3:
                k = k[:, None, :, :]  # Conv1D [k, in, out] -> [k, 1, in, out]
            params["W"] = k
            bias()
        elif cls == "SeparableConvolution2D":
            params["dW"] = kw.get("depthwise_kernel")
            params["pW"] = kw.get("pointwise_kernel")
            bias()
        elif cls == "EmbeddingLayer":
            params["W"] = kw.get("embeddings", kw.get("W"))
        elif cls in ("LSTM", "GravesLSTM"):
            K, R, b = kw.get("kernel"), kw.get("recurrent_kernel"), kw.get(
                "bias")
            if K is None and "W_i" in kw:  # Keras 1 per-gate weights
                K = np.concatenate([kw[f"W_{g}"] for g in "ifco"], 1)
                R = np.concatenate([kw[f"U_{g}"] for g in "ifco"], 1)
                b = np.concatenate([kw[f"b_{g}"] for g in "ifco"])

            def ifco_to_ifog(a, axis):
                i, f, c, o = np.split(a, 4, axis=axis)
                return np.concatenate([i, f, o, c], axis=axis)
            params["W"] = ifco_to_ifog(K, 1)
            params["RW"] = ifco_to_ifog(R, 1)
            if b is not None:
                params["b"] = ifco_to_ifog(b, 0)
        elif cls == "SimpleRnn":
            params["W"] = kw.get("kernel", kw.get("W"))
            params["RW"] = kw.get("recurrent_kernel", kw.get("U"))
            bias()
        elif cls == "BatchNormalization":
            for src, dst in (("gamma", "gamma"), ("beta", "beta")):
                if src in kw:
                    params[dst] = kw[src]
            for src, dst in (("moving_mean", "mean"),
                             ("moving_variance", "var")):
                if src in kw:
                    state[dst] = kw[src]
        return params, state

    @staticmethod
    def _coerce(arr: np.ndarray, expect, kname: str, pn: str) -> np.ndarray:
        """Shape-check against the layer's tensor; a 4-D mismatch that
        matches after OIHW -> HWIO is a Theano-dialect kernel
        (`KerasConvolution.java`'s dim ordering): transposed and flipped
        by 180 degrees."""
        expect = tuple(expect)
        if tuple(arr.shape) == expect:
            return arr
        if arr.ndim == 4 and np.transpose(arr, (2, 3, 1, 0)).shape == expect:
            return np.ascontiguousarray(
                np.transpose(arr, (2, 3, 1, 0))[::-1, ::-1])
        raise ValueError(f"layer {kname} param {pn}: {arr.shape} != {expect}")

    @staticmethod
    @torch.no_grad()
    def _apply_weights(layer, kw, kname):
        """Copy one Keras layer's weights into `layer`'s tensors (params
        by JAX name, moving statistics into the running state), each on
        the layer's device in the tensor's own memory layout."""
        params, state = KerasModelImport._convert(layer, kw)
        missing = [pn for pn, arr in params.items() if arr is None]
        if missing:
            raise ValueError(
                f"layer {kname}: could not match Keras weights for "
                f"{missing}; stored weight names were {sorted(kw)}")
        targets = layer.jax_param_map()
        for pn, arr in params.items():
            t = targets[pn]
            arr = KerasModelImport._coerce(np.asarray(arr), t.shape, kname,
                                           pn)
            t.copy_(torch.as_tensor(np.asarray(arr, np.float32)))
        running = layer.state_map()
        for sn, arr in state.items():
            running[sn].copy_(torch.as_tensor(np.asarray(arr, np.float32)))

    @staticmethod
    def _copy_weights(net, h5, keras_names):
        """Copy each named Keras layer's weights found in `h5` (an
        `Hdf5Archive`, or anything with its read methods) into `net`'s
        layer `key`."""
        root = KerasModelImport._weights_root(h5)
        layers = dict(net.keyed())
        for kname, key in keras_names:
            kw = KerasModelImport._layer_weights(h5, root, kname)
            if kw:
                KerasModelImport._apply_weights(layers[key], kw, kname)
        net.params_changed()
