"""Transfer learning: surgery on the configuration, then a copy of the
params that survive (counterpart of
`deeplearning4j_tpu/transferlearning/transfer.py`).

`TransferLearning.Builder(net)` edits a copy of the layer list:
`set_feature_extractor(i)` freezes layers 0..i, `n_out_replace` gives a
layer a new width (it and the next layer are drawn afresh),
`remove_output_layer` / `remove_layers_from_output` drop layers from
the end, `add_layer` appends (drawn afresh), and a
`FineTuneConfiguration` sets updater, l1, l2 and dropout on every layer
that is not frozen. `build(device=)` makes the new net, draws it with
the configuration's seed as JAX's `init()` does, and copies every
surviving param (and running state) whose layer and shape are kept.

A frozen layer is wrapped in the port's `FrozenLayer`: its updater is
NoOp, its params take no gradient and it runs in inference mode. JAX's
builder gives a frozen layer a NoOp updater instead; for layers without
dropout or running statistics (LeNet's) the two train the same
numbers, and the outputs are the same for any layer.

`TransferLearningHelper(net, frozen_upto)` featurizes data once through
the frozen prefix and trains the tail on the features, writing the
trained tail back into the whole net.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.common.updaters import Updater, get_updater
from deeplearning4j_tpu_torch.datasets.iterator import DataSet
from deeplearning4j_tpu_torch.nn.conf.builder import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers.base import Layer, layer_from_dict
from deeplearning4j_tpu_torch.nn.layers.misc import FrozenLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork


@dataclasses.dataclass
class FineTuneConfiguration:
    """Overrides applied to every layer that is not frozen."""

    updater: Optional[Updater] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    dropout: Optional[float] = None
    seed: Optional[int] = None

    def apply(self, layer: Layer) -> Layer:
        """`layer` with the overrides, as a fresh layer."""
        if self.updater is not None:
            layer.updater = get_updater(self.updater)
        if self.l1 is not None:
            layer.l1 = self.l1
        if self.l2 is not None:
            layer.l2 = self.l2
        if self.dropout is not None:
            layer.dropout = self.dropout
        return layer_from_dict(layer.to_dict())


def _with(layer: Layer, **fields) -> Layer:
    d = layer.to_dict()
    d.update(fields)
    return layer_from_dict(d)


@torch.no_grad()
def _copy_layer(src: Layer, dst: Layer):
    """Copy `src`'s params and running state into `dst` where the names
    and shapes match (a FrozenLayer reads and writes its inner
    layer's)."""
    for kind in ("jax_param_map", "state_map"):
        want = getattr(dst, kind)()
        for name, t in getattr(src, kind)().items():
            if name in want and tuple(want[name].shape) == tuple(t.shape):
                want[name].copy_(t.to(want[name].device))


class TransferLearning:
    class Builder:
        def __init__(self, net: MultiLayerNetwork):
            self._net = net
            self._layers: List[Layer] = [l.clone() for l in net.conf.layers]
            self._fine_tune: Optional[FineTuneConfiguration] = None
            self._frozen_upto = -1
            self._replaced: dict = {}
            self._appended: List[Layer] = []
            self._removed_from_output = 0

        def fine_tune_configuration(self, ftc: FineTuneConfiguration):
            self._fine_tune = ftc
            return self

        def set_feature_extractor(self, layer_idx: int):
            """Freeze layers [0..layer_idx]."""
            self._frozen_upto = layer_idx
            return self

        def n_out_replace(self, layer_idx: int, n_out: int,
                          weight_init=None):
            """Give layer `layer_idx` the width `n_out` and draw it and
            the next layer (whose n_in follows) afresh."""
            self._replaced[layer_idx] = (n_out, weight_init)
            return self

        def remove_output_layer(self):
            return self.remove_layers_from_output(1)

        def remove_layers_from_output(self, n: int):
            self._removed_from_output += n
            return self

        def add_layer(self, layer: Layer):
            self._appended.append(layer)
            return self

        def build(self, *, device="cuda") -> MultiLayerNetwork:
            """The new net on `device`, drawn with the configuration's
            seed, the surviving params copied from the old net."""
            old_net = self._net
            layers = list(self._layers)
            if self._removed_from_output:
                layers = layers[:-self._removed_from_output]
            reinit: set = set()
            for idx, (n_out, wi) in self._replaced.items():
                fields = {"n_out": n_out}
                if wi is not None:
                    fields["weight_init"] = wi
                layers[idx] = _with(layers[idx], **fields)
                reinit.add(idx)
                if idx + 1 < len(layers) and "n_in" in layers[
                        idx + 1].to_dict():
                    layers[idx + 1] = _with(layers[idx + 1], n_in=n_out)
                    reinit.add(idx + 1)
            base = len(layers)
            layers = layers + [l.clone() for l in self._appended]
            reinit.update(range(base, len(layers)))
            for i, l in enumerate(layers):
                if i <= self._frozen_upto:
                    layers[i] = FrozenLayer(layer=l)
                elif self._fine_tune is not None:
                    layers[i] = self._fine_tune.apply(l)
            old = old_net.conf
            conf = MultiLayerConfiguration(
                layers=layers,
                input_preprocessors={i: p for i, p in
                                     old.input_preprocessors.items()
                                     if i < len(layers)},
                input_type=old.input_type,
                seed=(self._fine_tune.seed if self._fine_tune
                      and self._fine_tune.seed else old.seed),
                backprop_type=old.backprop_type,
                tbptt_fwd_length=old.tbptt_fwd_length,
                tbptt_back_length=old.tbptt_back_length,
                gradient_normalization=old.gradient_normalization,
                gradient_normalization_threshold=(
                    old.gradient_normalization_threshold),
                max_norm=old.max_norm)
            new_net = MultiLayerNetwork(conf, device=device,
                                        dtype_policy=old_net.dtype).init()
            for i in range(min(len(layers), len(old_net.layers))):
                if i not in reinit:
                    _copy_layer(old_net.layers[i], new_net.layers[i])
            new_net.params_changed()
            return new_net


class TransferLearningHelper:
    """Featurize once through the frozen prefix (layers 0..frozen_upto),
    then train only the tail on the features."""

    def __init__(self, net: MultiLayerNetwork, frozen_upto: int):
        self.full_net = net
        self.frozen_upto = frozen_upto
        tail = [l.clone() for l in net.conf.layers[frozen_upto + 1:]]
        old = net.conf
        conf = MultiLayerConfiguration(
            layers=tail,
            input_preprocessors={i - (frozen_upto + 1): p for i, p in
                                 old.input_preprocessors.items()
                                 if i > frozen_upto},
            seed=old.seed, backprop_type=old.backprop_type,
            tbptt_fwd_length=old.tbptt_fwd_length)
        self.unfrozen = MultiLayerNetwork(conf, device=net.device,
                                          dtype_policy=net.dtype).init()
        for i in range(len(tail)):
            _copy_layer(net.layers[i + frozen_upto + 1],
                        self.unfrozen.layers[i])
        self.unfrozen.params_changed()

    def featurize(self, dataset: DataSet) -> DataSet:
        acts = self.full_net.feed_forward(dataset.features)
        return DataSet(acts[self.frozen_upto].float().cpu().numpy(),
                       dataset.labels, dataset.features_mask,
                       dataset.labels_mask)

    def fit_featurized(self, data, **kw):
        self.unfrozen.fit(data, **kw)
        for i in range(len(self.unfrozen.layers)):
            _copy_layer(self.unfrozen.layers[i],
                        self.full_net.layers[i + self.frozen_upto + 1])
        self.full_net.params_changed()
        return self

    def output_from_featurized(self, features):
        return self.unfrozen.output(features)
