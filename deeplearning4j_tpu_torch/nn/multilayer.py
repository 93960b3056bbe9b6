"""MultiLayerNetwork — the sequential container (counterpart of
`deeplearning4j_tpu/nn/multilayer.py`: `_forward_core` :210, `_loss_fn`
:322, `_packed_runs` :378, `_apply_updates` :410, `_make_train_step`
:479, `fit` :678, `output` :878, `feed_forward` :894, `score` :902,
`evaluate*` :915-963). What it shares with `ComputationGraph` (params
and running state, the dtype policy, regularization, the update, the
fit loop, evaluation) is `nn/container.py`'s; its own part is the
layer list's forward and loss.

Layers live in an `nn.ModuleList` in the JAX net's order, so layer `i`
here is layer `i` there, keyed "<i>", and `util.jax_params` can load the
JAX net's `{"<i>": {name: array}}` params, updater state and running
state directly. PyTorch runs eagerly: there is no jit, no
scan-over-layers and no pytree — the forward is a Python loop over the
layers. Inference (`output()`, `generate()`, serving) runs `_forward`
under `no_grad`; `fit` runs it with autograd (`nn/container.py` gives
the step's order). Runs of identical consecutive layers before the
output layer, with no input preprocessor inside, are the packed runs.

Randomness is JAX's (`common/prng.py`): the step's key is
`fold_in(key(seed + 1), iteration)`, layer i's `fold_in(step key, i)`,
its weight noise `fold_in(layer key, 0x5EED)`, and each layer folds
further as its JAX layer does, so dropout and weight noise draw JAX's
masks bit for bit (the dropout kernel on the card).

Masks: `fit` takes features and label masks from a `DataSet` or an
iterator, `output(mask=)`, `feed_forward(mask=)` and `score()` a
features mask; each layer's `forward_mask` carries it to the next, and
the loss takes the label mask, or the carried mask without one. Token
ids pass the dtype policy's input cast uncast (:227-231); `output()`
returns the output dtype (fp32).

Configuration (`nn/conf/builder.py`): a net is built from a
`MultiLayerConfiguration` (the JAX constructor, :95) or from a layer
list, and keeps the configuration as `.conf`, which
`util/serializer.py` writes. The input preprocessor of layer i
reshapes the activation and the mask (`process_mask`) before the layer,
where JAX applies it, the output layer's in the loss included.

Recurrent layers: `fit` takes truncated-BPTT steps when the
configuration asks for them and the features are [B, T, F]
(`nn/container.py` `_fit_tbptt`), and `rnn_time_step` streams inference
with carries kept across calls (the JAX `rnn_time_step` :989-1024).

Layerwise pretraining (`pretrain`, `nn/container.py`) trains each
layer with a `pretrain_loss` on the features of the layers before it
(the JAX `pretrain` :1075-1114); the configuration's `pretrain` flag is
inert in `fit`, as in JAX.

The training runtime (`nn/container.py`): `steps_per_execution`
groups, `data_format` (NCHW, NCW/NFT) on `fit`, `output`,
`feed_forward`, `evaluate*` and `rnn_time_step`, the line-search
`optimization_algo`s (`optimize/solvers.py`), each layer's
`remat_policy`, `copy`, `set_param_table` and `resume` (`fault/`).

Diagnostics and telemetry (`monitor/`, `nn/container.py`): the
constructor's `diagnostics=` (or the configuration's field, or
`DL4J_DIAGNOSTICS`) turns on the per-layer statistics and the
non-finite watchdog; the activation statistics are taken in `_forward`
from each layer's output before the output layer, as the JAX
`_forward_core` takes them (:267-271).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from deeplearning4j_tpu_torch.datasets.iterator import as_iterator
from deeplearning4j_tpu_torch.monitor.diagnostics import activation_stats
from deeplearning4j_tpu_torch.nn.conf.builder import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.container import (
    MIN_RUN,
    Container,
    convert_features,
    convert_labels,
    layer_signature,
)
from deeplearning4j_tpu_torch.nn.layers.feedforward import (
    BaseOutputLayerMixin,
    EmbeddingLayer,
)
from deeplearning4j_tpu_torch.nn.layers.recurrent import BaseRecurrentLayer


class MultiLayerNetwork(Container):
    def __init__(self, conf_or_layers, *, device="cuda", dtype_policy=None,
                 diagnostics=None):
        """A net from a `MultiLayerConfiguration` (its layers become the
        net's, as in JAX, and the conf stays as `.conf`) or from a list
        of layer modules (a `.conf` is made from them, so the net can be
        written). A conf whose layers already belong to a net is copied
        first, so two nets never share params. Params are zeros (norm
        gains ones) until `init` draws them or a loader fills them.
        `diagnostics` (a `DiagnosticsConfig`, True, a watchdog name or
        the serde dict) beats the configuration's field."""
        super().__init__()
        if isinstance(conf_or_layers, MultiLayerConfiguration):
            conf = conf_or_layers
            if any(getattr(l, "_in_net", False) for l in conf.layers):
                conf = MultiLayerConfiguration.from_dict(conf.to_dict())
        else:
            conf = MultiLayerConfiguration(layers=list(conf_or_layers))
        n = len(conf.layers)
        self._setup(conf, conf.layers, [str(i) for i in range(n)],
                    {str(i): i for i in range(n)}, device, dtype_policy,
                    diagnostics)

    # ----------------------------------------------------------- forward
    def _forward(self, x, carries: Optional[Dict[str, object]] = None,
                 upto: Optional[int] = None, *, train: bool = False,
                 rng=None, mask=None, collect: Optional[list] = None,
                 new_state: Optional[dict] = None,
                 acts: Optional[dict] = None):
        """The forward through layers [0, upto). Without carries: each
        layer's full-sequence `forward` with its key `fold_in(rng, i)`
        (None without `rng`) and the mask the layers before it carried.
        With carries (streaming decode / prefill, truncated BPTT):
        recurrent layers run `forward_with_carry` from `carries[str(i)]`
        (their fresh carry when absent), with their keys and weight noise
        in training. `collect` gets each layer's output appended;
        `new_state` the running state of the stateful layers in
        training; `acts` each layer's activation statistics
        ({"<i>": [mean, std, dead]}, the diagnostics'). Returns
        (h, new_carries, mask)."""
        if not isinstance(self.layers[0], EmbeddingLayer):
            # token ids pass uncast: a bf16 round corrupts ids above 256
            x = self.dtype.cast_compute(x)
        h = x
        new_carries = {}
        pre = self.conf.input_preprocessors
        for i, layer in enumerate(self.layers[:upto]):
            if i in pre:
                h, mask = self._pre_process(i, h, mask)
            if carries is not None and isinstance(layer, BaseRecurrentLayer):
                h, new_carries[str(i)] = self._call_with_carry(
                    str(i), layer, h, carries.get(str(i)), train=train,
                    rng=rng, mask=mask)
            else:
                h = self._call_layer(str(i), layer, h, train=train, rng=rng,
                                     mask=mask, new_state=new_state)
            mask = layer.forward_mask(mask)
            if collect is not None:
                collect.append(h)
            if acts is not None:
                acts[str(i)] = activation_stats(h)
        return h, new_carries, mask

    def _pre_process(self, i, h, mask):
        """Layer i's input preprocessor on the activation and on the
        mask (the JAX `pre_process` then `process_mask`, :243-244)."""
        pp = self.conf.input_preprocessors[i]
        return pp.pre_process(h, mask), pp.process_mask(mask)

    @torch.no_grad()
    def _forward_core(self, x, carries: Optional[Dict[str, object]] = None):
        """The inference forward (no autograd): scoring, generate() and
        serving. Returns (h, new_carries)."""
        return self._forward(x, carries)[:2]

    def _inputs(self, x, data_format=None):
        x = convert_features(x, data_format)
        return (x.to(self.device) if isinstance(x, torch.Tensor)
                else self._features(x))

    @torch.no_grad()
    def output(self, x, mask=None, *, data_format=None):
        """Forward pass to the final activation (the JAX `output`):
        token ids [B, T] -> [B, T, V] softmax for the LM, in the output
        dtype (fp32); `mask` [B, T] is the padding mask (1 where real).
        Arrays take `fit`'s feature path (float-carried ids are checked
        and made int64); tensors pass as they are. `data_format` names
        the features' layout (NCHW, NCW/NFT; None is native)."""
        x, mask = self._inputs(x, data_format), self._mask(mask)
        return self.dtype.cast_output(
            self._policy_call(lambda: self._forward(x, mask=mask)[0]))

    @torch.no_grad()
    def feed_forward(self, x, mask=None, *,
                     data_format=None) -> List[torch.Tensor]:
        """Every layer's activation, in layer order (the JAX
        `feed_forward`: no dropout, in the compute dtype)."""
        x, mask, acts = (self._inputs(x, data_format), self._mask(mask),
                         [])
        self._policy_call(lambda: self._forward(x, mask=mask, collect=acts))
        return acts

    def _output_positions(self):
        return [len(self.layers) - 1]

    def _eval_output(self, features, features_mask, data_format=None):
        return self.output(features, mask=features_mask,
                           data_format=data_format)

    # --------------------------------------------------------------- loss
    def _loss_fn(self, x, y, fmask=None, lmask=None, *, train=False,
                 rng=None, new_state=None, carries=None, carries_out=None,
                 acts=None):
        """The output layer's loss on the forward through the layers
        before it, plus the l1/l2 penalty and the auxiliary losses the
        training forward left in `new_state` (the JAX `_loss_fn`). The
        label mask defaults to the
        mask the layers carried; the output layer's key is
        `fold_in(rng, n - 1)`. With `carries` (truncated BPTT) the
        recurrent layers run from them and leave their new carries in
        `carries_out`; `acts` collects the activation statistics of the
        layers before the output layer."""
        out = self.layers[-1]
        if not isinstance(out, BaseOutputLayerMixin):
            raise ValueError(f"the last layer ({type(out).__name__}) has no "
                             f"loss; fit needs an output layer")
        self._check_trainable()
        n = len(self.layers)
        h, new_carries, mask = self._forward(
            x, carries, upto=n - 1, train=train, rng=rng, mask=fmask,
            new_state=new_state, acts=acts)
        if carries_out is not None:
            carries_out.update(new_carries)
        if n - 1 in self.conf.input_preprocessors:
            h, mask = self._pre_process(n - 1, h, mask)
        loss = self._output_loss(
            str(n - 1), out, h, y, lmask if lmask is not None else mask,
            train=train, rng=rng)
        return self.dtype.cast_output(loss) + (self._regularization()
                                               + self._pop_aux(new_state))

    # ------------------------------------------------------------ updates
    def _candidate_runs(self) -> List[List[int]]:
        """Maximal runs of consecutive layers with one signature, the
        output layer excluded and no input preprocessor inside (the JAX
        `scan_stack.build_layer_plan` over n - 1 layers)."""
        runs, i, n = [], 0, len(self.layers) - 1
        pre = self.conf.input_preprocessors
        while i < n:
            sig = layer_signature(self.layers[i])
            j = i + 1
            if sig is not None:
                while (j < n and j not in pre
                       and layer_signature(self.layers[j]) == sig):
                    j += 1
            if j - i >= MIN_RUN:
                runs.append(list(range(i, j)))
            i = j
        return runs

    # ----------------------------------------------------- truncated BPTT
    def _tbptt_time(self, x):
        return (int(x.shape[1]) if self._is_tbptt() and x.ndim == 3
                else None)

    def _batch_of(self, x) -> int:
        return int(x.shape[0])

    def _chunk(self, x, y, fmask, lmask, s, L):
        return (x[:, s:s + L], y[:, s:s + L] if y.ndim == 3 else y,
                None if fmask is None else fmask[:, s:s + L],
                None if lmask is None else
                (lmask[:, s:s + L] if lmask.ndim >= 2 else lmask))

    # ------------------------------------------------------ rnn streaming
    def rnn_time_step(self, x, *, data_format=None):
        """Streaming inference carrying every recurrent layer's state
        across calls (the JAX `rnn_time_step`): [B, F] is one step (the
        output loses its time axis), [B, T, F] a chunk; with an
        embedding over a recurrent input the features are [B, T] token
        ids. Returns the last layer's activation in the compute dtype.
        `rnn_clear_previous_state()` starts a new sequence."""
        x = self._inputs(x, data_format)
        ids_input = bool(getattr(self.layers[0], "time_series_input",
                                 False))
        squeeze = x.ndim == 2 and not ids_input
        if squeeze:
            x = x[:, None, :]
        t_new = int(x.shape[1]) if x.ndim in (2, 3) else 1
        h = self._stream(lambda c: self._forward(x, c)[:2], int(x.shape[0]),
                         t_new)
        return h[:, -1, :] if squeeze and h.ndim == 3 else h

    # ----------------------------------------------------------- pretrain
    def _pretrain_targets(self):
        return [(str(i), layer) for i, layer in enumerate(self.layers)
                if hasattr(layer, "pretrain_loss")]

    @torch.no_grad()
    def _pretrain_features(self, key, features):
        """Layers [0, key) in inference mode under the policy; the
        result in the param dtype (JAX promotes the compute-dtype
        features against the layer's fp32 params)."""
        x = self._inputs(features)
        h = self._policy_call(lambda: self._forward(x, upto=int(key))[0])
        return h.to(self.dtype.param_dtype)

    # ---------------------------------------------------------------- fit
    def _features(self, x) -> torch.Tensor:
        return self._features_for(x, self.layers[0])

    def _input_consumer(self):
        return self.layers[0]

    def _batch(self, ds, data_format):
        if ds.labels is None:
            raise ValueError("fit needs labels")
        masks = {k: self._mask(m) for k, m in (
            ("fmask", ds.features_mask),
            ("lmask", convert_labels(ds.labels_mask, data_format)))
            if m is not None}
        return (self._features(convert_features(ds.features, data_format)),
                self._labels(convert_labels(ds.labels, data_format)), masks)

    def fit(self, data, labels=None, *, epochs: int = 1, batch_size: int = 32,
            data_format=None, shuffle: bool = True,
            steps_per_execution: int = 1):
        """Train (the JAX `fit`): `data` is an iterator of `DataSet`s, a
        `DataSet` (or a list of them), or a feature array with `labels`,
        shuffled each epoch by JAX's stream. Under `backprop_type`
        tbptt each [B, T, F] minibatch is one iteration of truncated-BPTT
        chunks; under a line-search `optimization_algo` each minibatch
        is one `Solver.optimize`. `data_format` names the features'
        layout (NCHW; NCW/NFT, labels too); `steps_per_execution` groups
        minibatches (`nn/container.py` `_fit_iterator`)."""
        return self._fit_iterator(
            as_iterator(data, labels, batch_size=batch_size,
                        shuffle=shuffle), epochs, steps_per_execution,
            data_format)

    @torch.no_grad()
    def score(self, dataset=None) -> float:
        """The loss (with the l1/l2 penalty, no dropout) on `dataset` (a
        `DataSet`, its masks applied), or the last fit minibatch's score
        without one."""
        if dataset is None:
            return self.score_value
        x, y = self._features(dataset.features), self._labels(dataset.labels)
        fmask, lmask = (self._mask(dataset.features_mask),
                        self._mask(dataset.labels_mask))
        return float(self._policy_call(
            lambda: self._loss_fn(x, y, fmask, lmask), output_params=True))
