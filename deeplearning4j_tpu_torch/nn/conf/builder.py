"""NeuralNetConfiguration builder -> MultiLayerConfiguration (counterpart
of `deeplearning4j_tpu/nn/conf/builder.py`: `check_format_version` :31,
`GradientNormalization` :70, `BackpropType` :81,
`MultiLayerConfiguration` :87-190, `_policy_to_dict` :192,
`infer_preprocessor` :254, `ListBuilder` :283-417,
`NeuralNetConfiguration` :423-578).

The JSON form is the JAX package's key for key and in the same order,
so a `configuration.json` written by either package builds the other's
network. Global defaults reach a layer when the layer still carries its
default for the field (`apply_global_defaults`), so the port's layer
defaults are the JAX layers'.

The configuration carries every field, ported or not. Those the port
does not run yet (gradient normalization, TBPTT, `max_norm`,
`pretrain`, the line-search solvers, diagnostics) are inert at
inference and refused by the container's `fit` (`nn/multilayer.py`).
`diagnostics` travels as the JAX package's serde dict.
"""

from __future__ import annotations

import dataclasses
import json
from enum import Enum
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.common.updaters import Sgd, Updater, get_updater
from deeplearning4j_tpu_torch.common.weights import WeightInit
from deeplearning4j_tpu_torch.nd.dtype import as_policy
from deeplearning4j_tpu_torch.nn.conf.inputs import (
    InputType,
    InputTypeConvolutional,
    InputTypeConvolutionalFlat,
    InputTypeRecurrent,
)
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    CnnToFeedForwardPreProcessor,
    CnnToRnnPreProcessor,
    FeedForwardToCnnPreProcessor,
    FeedForwardToRnnPreProcessor,
    InputPreProcessor,
    RnnToFeedForwardPreProcessor,
    preprocessor_from_dict,
)
from deeplearning4j_tpu_torch.nn.layers.base import (
    REMAT_POLICIES,
    Layer,
    layer_from_dict,
)

CONFIG_FORMAT_VERSION = 1

# the JAX package's OptimizationAlgorithm values
# (deeplearning4j_tpu/optimize/solvers.py:33)
OPTIMIZATION_ALGOS = ("sgd", "line_gradient_descent", "conjugate_gradient",
                      "lbfgs")
GRADIENT_SHARING_MODES = ("dense", "threshold", "dense_rs", "threshold_rs")


def check_format_version(d: dict, what: str):
    v = d.get("format_version", 1)  # pre-versioning payloads are v1
    if not isinstance(v, int) or v < 1:
        raise ValueError(f"{what}: invalid format_version {v!r}")
    if v > CONFIG_FORMAT_VERSION:
        raise ValueError(
            f"{what}: payload format_version {v} is newer than this "
            f"build's {CONFIG_FORMAT_VERSION} — upgrade the library to "
            f"load it")


class GradientNormalization(str, Enum):
    NONE = "none"
    RENORMALIZE_L2_PER_LAYER = "renormalize_l2_per_layer"
    RENORMALIZE_L2_PER_PARAM_TYPE = "renormalize_l2_per_param_type"
    CLIP_ELEMENTWISE_ABSOLUTE_VALUE = "clip_elementwise_absolute_value"
    CLIP_L2_PER_LAYER = "clip_l2_per_layer"
    CLIP_L2_PER_PARAM_TYPE = "clip_l2_per_param_type"


class BackpropType(str, Enum):
    STANDARD = "standard"
    TRUNCATED_BPTT = "tbptt"


def _policy_to_dict(p):
    """Serde form of a dtype_policy value (a policy, a preset name or a
    serde dict)."""
    return as_policy(p).to_dict()


def _policy_from_serde(d):
    return None if d is None else as_policy(d)


def _diagnostics(spec):
    """The diagnostics field as its serde dict (None: off). The port
    carries the JAX package's dict as it is; other specs (True, "on", a
    watchdog name) need `monitor/diagnostics`, which is not ported."""
    if spec is None or spec is False:
        return None
    if isinstance(spec, dict):
        return dict(spec)
    raise NotImplementedError(
        f"diagnostics spec {spec!r}: only the serde dict is carried; "
        f"monitor/diagnostics is not ported (ROADMAP Queue 1 item 10)")


@dataclasses.dataclass
class MultiLayerConfiguration:
    """Everything a MultiLayerNetwork needs, as data (the JAX class's
    fields and defaults)."""

    layers: List[Layer] = dataclasses.field(default_factory=list)
    input_preprocessors: Dict[int, InputPreProcessor] = dataclasses.field(
        default_factory=dict)
    input_type: Optional[InputType] = None
    seed: int = 12345
    backprop_type: BackpropType = BackpropType.STANDARD
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
    gradient_normalization: GradientNormalization = GradientNormalization.NONE
    gradient_normalization_threshold: float = 1.0
    max_norm: Optional[float] = None
    pretrain: bool = False
    optimization_algo: str = "sgd"
    max_iterations: int = 5
    scan_layers: bool = True
    gradient_sharing: str = "dense"
    gradient_sharing_threshold: float = 1e-3
    dtype_policy: Optional[Any] = None
    diagnostics: Optional[dict] = None

    def to_dict(self):
        return {
            "format": "deeplearning4j_tpu.MultiLayerConfiguration",
            "format_version": CONFIG_FORMAT_VERSION,
            "layers": [l.to_dict() for l in self.layers],
            "input_preprocessors": {str(i): p.to_dict() for i, p in
                                    self.input_preprocessors.items()},
            "input_type": (None if self.input_type is None
                           else self.input_type.to_dict()),
            "seed": self.seed,
            "backprop_type": BackpropType(self.backprop_type).value,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_back_length": self.tbptt_back_length,
            "gradient_normalization": GradientNormalization(
                self.gradient_normalization).value,
            "gradient_normalization_threshold":
                self.gradient_normalization_threshold,
            "max_norm": self.max_norm,
            "pretrain": self.pretrain,
            "optimization_algo": self.optimization_algo,
            "max_iterations": self.max_iterations,
            "scan_layers": self.scan_layers,
            "gradient_sharing": self.gradient_sharing,
            "gradient_sharing_threshold": self.gradient_sharing_threshold,
            "dtype_policy": (None if self.dtype_policy is None
                             else _policy_to_dict(self.dtype_policy)),
            "diagnostics": _diagnostics(self.diagnostics),
        }

    def to_json(self, **kw):
        return json.dumps(self.to_dict(), **kw)

    @staticmethod
    def from_dict(d: dict) -> "MultiLayerConfiguration":
        check_format_version(d, "MultiLayerConfiguration")
        return MultiLayerConfiguration(
            layers=[layer_from_dict(ld) for ld in d["layers"]],
            input_preprocessors={
                int(i): preprocessor_from_dict(p)
                for i, p in d.get("input_preprocessors", {}).items()},
            input_type=(None if d.get("input_type") is None
                        else InputType.from_dict(d["input_type"])),
            seed=d.get("seed", 12345),
            backprop_type=BackpropType(d.get("backprop_type", "standard")),
            tbptt_fwd_length=d.get("tbptt_fwd_length", 20),
            tbptt_back_length=d.get("tbptt_back_length", 20),
            gradient_normalization=GradientNormalization(
                d.get("gradient_normalization", "none")),
            gradient_normalization_threshold=d.get(
                "gradient_normalization_threshold", 1.0),
            max_norm=d.get("max_norm"),
            pretrain=d.get("pretrain", False),
            optimization_algo=d.get("optimization_algo", "sgd"),
            max_iterations=d.get("max_iterations", 5),
            scan_layers=d.get("scan_layers", True),
            gradient_sharing=d.get("gradient_sharing", "dense"),
            gradient_sharing_threshold=d.get("gradient_sharing_threshold",
                                             1e-3),
            dtype_policy=_policy_from_serde(d.get("dtype_policy")),
            diagnostics=_diagnostics(d.get("diagnostics")),
        )

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        return MultiLayerConfiguration.from_dict(json.loads(s))


# ------------------------------------------- n_in and preprocessor inference
def _family(input_type: InputType) -> str:
    if isinstance(input_type, InputTypeConvolutional):
        return "cnn"
    if isinstance(input_type, InputTypeConvolutionalFlat):
        return "cnnflat"
    if isinstance(input_type, InputTypeRecurrent):
        return "rnn"
    return "ff"


# the input family each JAX layer consumes natively (the JAX
# `_expected_family`); a name not listed is feed-forward
_FAMILIES = {
    "cnn": ("convolution", "subsampling", "upsampling2d", "zeropadding",
            "space_to_depth", "lrn", "yolo2_output",
            "separable_convolution2d", "pool_helper"),
    "rnn": ("lstm", "graves_lstm", "graves_bidirectional_lstm",
            "simple_rnn", "rnn_output", "convolution1d", "subsampling1d",
            "zeropadding1d", "upsampling1d", "last_time_step",
            "multi_head_attention"),
    "any": ("batchnorm", "activation", "dropout_layer", "global_pooling",
            "loss", "reshape", "permute", "layernorm", "embedding",
            "positional_encoding", "transformer_encoder"),
}


def _expected_family(layer: Layer) -> str:
    for family, names in _FAMILIES.items():
        if layer.layer_name in names:
            return family
    return "ff"


def infer_preprocessor(input_type: InputType,
                       layer: Layer) -> Optional[InputPreProcessor]:
    """Automatic preprocessor insertion (the JAX `infer_preprocessor`)."""
    have, want = _family(input_type), _expected_family(layer)
    if want == "any" or have == want:
        return None
    it = input_type
    if have == "cnnflat" and want == "cnn":
        return FeedForwardToCnnPreProcessor(it.height, it.width, it.channels)
    if have == "cnnflat" and want == "ff":
        return None
    if have == "cnn" and want == "ff":
        return CnnToFeedForwardPreProcessor(it.height, it.width, it.channels)
    if have == "cnn" and want == "rnn":
        return CnnToRnnPreProcessor(it.height, it.width, it.channels)
    if have == "rnn" and want == "ff":
        return RnnToFeedForwardPreProcessor()
    if have == "ff" and want == "rnn":
        return FeedForwardToRnnPreProcessor(timesteps=0)
    if have == "rnn" and want == "cnn":
        raise ValueError("rnn→cnn requires an explicit RnnToCnnPreProcessor "
                         "with h/w/c")
    if have == "cnnflat" and want == "rnn":
        return FeedForwardToRnnPreProcessor(timesteps=0)
    if have == "ff" and want == "cnn":
        raise ValueError(
            "feed-forward→cnn requires setInputType(InputType."
            "convolutional_flat(...)) or an explicit "
            "FeedForwardToCnnPreProcessor")
    return None


def _has_explicit_n_in(layer: Layer) -> bool:
    return getattr(layer, "n_in", 0) not in (0, None)


class ListBuilder:
    """`NeuralNetConfiguration.Builder.list()` equivalent."""

    def __init__(self, global_conf: "NeuralNetConfiguration"):
        self._g = global_conf
        self._layers: List[Layer] = []
        self._preprocessors: Dict[int, InputPreProcessor] = {}
        self._input_type: Optional[InputType] = None
        self._backprop_type = BackpropType.STANDARD
        self._tbptt_fwd = 20
        self._tbptt_back = 20
        self._pretrain = False
        self._scan_layers = True
        self._gradient_sharing = "dense"
        self._gradient_sharing_threshold = 1e-3
        self._dtype_policy = global_conf.dtype_policy_value
        self._diagnostics = global_conf.diagnostics_value

    def layer(self, layer_or_idx, maybe_layer=None) -> "ListBuilder":
        layer = maybe_layer if maybe_layer is not None else layer_or_idx
        self._layers.append(layer)
        return self

    def input_preprocessor(self, idx: int,
                           p: InputPreProcessor) -> "ListBuilder":
        self._preprocessors[idx] = p
        return self

    def set_input_type(self, input_type: InputType) -> "ListBuilder":
        self._input_type = input_type
        return self

    def backprop_type(self, bptype, fwd_length: int = 20,
                      back_length: int = None) -> "ListBuilder":
        self._backprop_type = BackpropType(bptype)
        self._tbptt_fwd = fwd_length
        self._tbptt_back = (back_length if back_length is not None
                            else fwd_length)
        return self

    def t_bptt_lengths(self, fwd: int, back: int = None) -> "ListBuilder":
        return self.backprop_type(BackpropType.TRUNCATED_BPTT, fwd, back)

    def pretrain(self, flag: bool) -> "ListBuilder":
        self._pretrain = flag
        return self

    def scan_layers(self, flag: bool) -> "ListBuilder":
        self._scan_layers = bool(flag)
        return self

    def gradient_sharing(self, mode: str,
                         threshold: Optional[float] = None) -> "ListBuilder":
        if mode not in GRADIENT_SHARING_MODES:
            raise ValueError(
                f"gradient_sharing must be dense|threshold|dense_rs|"
                f"threshold_rs, got {mode!r}")
        self._gradient_sharing = mode
        if threshold is not None:
            self._gradient_sharing_threshold = float(threshold)
        return self

    def dtype_policy(self, policy) -> "ListBuilder":
        self._dtype_policy = as_policy(policy)
        return self

    def diagnostics(self, spec) -> "ListBuilder":
        self._diagnostics = _diagnostics(spec)
        return self

    def build(self) -> MultiLayerConfiguration:
        g = self._g
        layers = [l.clone() for l in self._layers]
        for l in layers:
            g.apply_global_defaults(l)

        preprocessors = dict(self._preprocessors)
        current = self._input_type
        if (current is None and layers and _has_explicit_n_in(layers[0])
                and _expected_family(layers[0]) in ("ff", "any")):
            # nIn on the first layer and no input type: the feed-forward
            # type, so the n_in chain resolves
            current = InputType.feed_forward(layers[0].n_in)
        if current is not None:
            for i, l in enumerate(layers):
                if i in preprocessors:
                    current = preprocessors[i].get_output_type(current)
                else:
                    auto = infer_preprocessor(current, l)
                    if auto is not None:
                        preprocessors[i] = auto
                        current = auto.get_output_type(current)
                    elif (_family(current) == "cnnflat"
                          and _expected_family(l) in ("ff", "any")):
                        current = InputType.feed_forward(current.arity())
                l.set_n_in(current, override=not _has_explicit_n_in(l))
                current = l.get_output_type(current)

        return MultiLayerConfiguration(
            layers=layers,
            input_preprocessors=preprocessors,
            input_type=self._input_type,
            seed=g.seed_value,
            backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_back_length=self._tbptt_back,
            gradient_normalization=g.gradient_normalization_value,
            gradient_normalization_threshold=(
                g.gradient_normalization_threshold_value),
            max_norm=g.max_norm_value,
            pretrain=self._pretrain,
            optimization_algo=g.optimization_algo_value,
            max_iterations=g.max_iterations_value,
            scan_layers=self._scan_layers,
            gradient_sharing=self._gradient_sharing,
            gradient_sharing_threshold=self._gradient_sharing_threshold,
            dtype_policy=self._dtype_policy,
            diagnostics=self._diagnostics,
        )


class NeuralNetConfiguration:
    """Fluent global-defaults builder (reference
    `NeuralNetConfiguration.Builder`)."""

    def __init__(self):
        self.seed_value = 12345
        self.updater_value: Updater = Sgd(1e-3)
        self.weight_init_value: Optional[WeightInit] = None
        self.dist_value = None
        self.l1_value = 0.0
        self.l2_value = 0.0
        self.l1_bias_value = 0.0
        self.l2_bias_value = 0.0
        self.dropout_value = None
        self.gradient_normalization_value = GradientNormalization.NONE
        self.gradient_normalization_threshold_value = 1.0
        self.max_norm_value: Optional[float] = None
        self.remat_policy_value: Optional[str] = None
        self.activation_value = None
        self.optimization_algo_value = "sgd"
        self.max_iterations_value = 5
        self.dtype_policy_value = None
        self.diagnostics_value = None

    @staticmethod
    def builder() -> "NeuralNetConfiguration":
        return NeuralNetConfiguration()

    def seed(self, s: int):
        self.seed_value = int(s)
        return self

    def updater(self, u):
        self.updater_value = get_updater(u)
        return self

    def weight_init(self, wi, dist=None):
        self.weight_init_value = WeightInit(wi)
        if dist is not None:
            self.dist_value = dist
        return self

    def dist(self, d):
        self.dist_value = d
        self.weight_init_value = WeightInit.DISTRIBUTION
        return self

    def activation(self, a):
        self.activation_value = a
        return self

    def l1(self, v):
        self.l1_value = v
        return self

    def l2(self, v):
        self.l2_value = v
        return self

    def l1_bias(self, v):
        self.l1_bias_value = v
        return self

    def l2_bias(self, v):
        self.l2_bias_value = v
        return self

    def dropout(self, retain_prob):
        self.dropout_value = retain_prob
        return self

    def gradient_normalization(self, gn, threshold: float = 1.0):
        self.gradient_normalization_value = GradientNormalization(gn)
        self.gradient_normalization_threshold_value = threshold
        return self

    def remat_policy(self, policy: Optional[str]):
        if policy is not None and policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy must be one of {REMAT_POLICIES} "
                             f"(or None); got {policy!r}")
        self.remat_policy_value = policy
        return self

    def optimization_algo(self, algo):
        value = getattr(algo, "value", algo)
        if value not in OPTIMIZATION_ALGOS:
            raise ValueError(f"optimization_algo must be one of "
                             f"{OPTIMIZATION_ALGOS}; got {algo!r}")
        self.optimization_algo_value = value
        return self

    def max_iterations(self, n: int):
        self.max_iterations_value = int(n)
        return self

    def dtype_policy(self, policy):
        self.dtype_policy_value = as_policy(policy)
        return self

    def diagnostics(self, spec):
        self.diagnostics_value = _diagnostics(spec)
        return self

    def constrain_max_norm(self, v: float):
        self.max_norm_value = v
        return self

    def apply_global_defaults(self, layer: Layer):
        """Push builder-level defaults into a layer that still carries the
        default for the field (the JAX `apply_global_defaults`)."""
        if layer.updater is None:
            layer.updater = self.updater_value
        if (self.weight_init_value is not None
                and layer.weight_init == WeightInit.XAVIER):
            layer.weight_init = self.weight_init_value
        if self.dist_value is not None and layer.dist is None:
            layer.dist = self.dist_value
        if layer.l1 == 0.0:
            layer.l1 = self.l1_value
        if layer.l2 == 0.0:
            layer.l2 = self.l2_value
        if layer.l1_bias == 0.0:
            layer.l1_bias = self.l1_bias_value
        if layer.l2_bias == 0.0:
            layer.l2_bias = self.l2_bias_value
        if layer.remat_policy is None and self.remat_policy_value is not None:
            layer.remat_policy = self.remat_policy_value
        if layer.dropout is None and self.dropout_value is not None:
            layer.dropout = self.dropout_value

    def list(self) -> ListBuilder:
        return ListBuilder(self)
