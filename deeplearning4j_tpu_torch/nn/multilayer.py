"""MultiLayerNetwork — the sequential container (counterpart of
`deeplearning4j_tpu/nn/multilayer.py`: `_forward_core` :210, `_loss_fn`
:322, `_packed_runs` :378, `_apply_updates` :410, `fit` :678, `output`
:878, `score` :902).

Layers live in an `nn.ModuleList` in the JAX net's order, so layer `i`
here is layer `i` there and `util.jax_params` can load the JAX net's
`{"<i>": {name: array}}` params and updater state directly. PyTorch
runs eagerly: there is no jit, no scan-over-layers and no pytree — the
forward is a Python loop over the layers.

Inference (`output()`, `generate()`, serving) runs `_forward_core`
under `no_grad`. Training (`fit`) runs the same loop with autograd: the
forward to the output layer, the output layer's loss, `backward()`,
then `_apply_updates`. Params take gradients only inside the train
step. Maximal runs of at least `MIN_RUN` structurally identical layers
(the LM's blocks; never the output layer) are the JAX package's packed
runs: an Adam run is ONE fused-Adam update, and so is each Adam layer
outside a run (the JAX package updates those per leaf with the same
arithmetic). Every other rule updates per leaf. Updates happen in
place.

Dtype policy (`nd/dtype.py`, the JAX `self.dtype`): under a mixed
policy such as `mixed_bf16` each step makes ONE compute-dtype copy of
every floating param, outside the differentiated function, and runs
`fit`'s forward, `score()` and `output()` on those copies through
`torch.func.functional_call` (the JAX container casts the param tree
once and differentiates the cast tree, :509-514). So the gradients are
bf16 (a shared param's too: one copy, one bf16 accumulation), the
params and the updater state stay the fp32 master, and the updater
upcasts each gradient (:466-468). Token ids pass uncast (:227-231). The
output layer sees `cast_output(h)` and `cast_output(y)`, and its params
are the copies rounded to bf16 and upcast again (:347-350), so the loss
is fp32; `output()` runs every layer in bf16 and returns fp32.

Params version: `params_version` counts the writes of the params
(`_apply_updates`, `init`, `to`, `load_state_dict`, and through
`params_changed()` `util.jax_params` loading and `restore_model`). The
serving tree (`nd.quant.serving_params`: int8 weights, the
compute-dtype copies under a mixed policy) is cached on it, so decoding
after a `fit` reads the new weights. Code that writes a param in place
by hand calls `params_changed()`.

Configuration (`nn/conf/builder.py`): a net is built from a
`MultiLayerConfiguration` (the JAX constructor, :95) or from a layer
list, and keeps the configuration as `.conf`, which
`util/serializer.py` writes. Input preprocessors run before their
layer, as in JAX; none is ported yet, so a configuration with one
builds and its forward raises.

Not ported yet, and refused rather than ignored: steps_per_execution >
1, masks, ring or Ulysses attention under a mixed policy, and, in
`fit` and `score` (`_check_trainable`), every configured field that
acts only in training: dropout, attention dropout, weight noise,
constraints, non-zero l1/l2, `max_norm`, gradient normalization,
truncated BPTT, `pretrain`, a line-search `optimization_algo` and
diagnostics.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from deeplearning4j_tpu_torch.common.updaters import Adam, Sgd
from deeplearning4j_tpu_torch.datasets.iterator import as_iterator
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.kernels.fused_adam import adam_update_packed
from deeplearning4j_tpu_torch.nd.dtype import DataTypePolicy, resolve_policy
from deeplearning4j_tpu_torch.nn.conf.builder import (
    BackpropType,
    GradientNormalization,
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.parallel import current_sequence_mesh
from deeplearning4j_tpu_torch.nn.layers.feedforward import (
    BaseOutputLayerMixin,
    EmbeddingLayer,
)
from deeplearning4j_tpu_torch.nn.layers.recurrent import BaseRecurrentLayer

MIN_RUN = 2          # shortest run of identical layers that packs


def layer_signature(layer):
    """Structural identity of a layer with params (None without): its
    class, the plain config values of it and its sublayers, its
    updater, and its params' names, shapes and dtypes."""
    pmap = layer.jax_param_map()
    if not pmap:
        return None
    conf = tuple(
        (type(m).__name__, tuple(sorted(
            (k, v) for k, v in vars(m).items() if not k.startswith("_")
            and isinstance(v, (bool, int, float, str, type(None))))))
        for m in layer.modules())
    upd = layer.updater.to_dict() if layer.updater is not None else None
    shapes = tuple(sorted((k, tuple(t.shape), str(t.dtype))
                          for k, t in pmap.items()))
    return type(layer).__name__, conf, repr(upd), shapes


def _check_policy(policy: DataTypePolicy) -> DataTypePolicy:
    """The policies the port runs: fp32 master params and fp32 outputs,
    compute in fp32 or bf16 (the kernels' two dtypes)."""
    if (policy.param_dtype != torch.float32
            or policy.output_dtype != torch.float32
            or policy.compute_dtype not in (torch.float32, torch.bfloat16)):
        raise NotImplementedError(
            f"dtype policy {policy.to_dict()} is not ported: the port keeps "
            f"fp32 params and outputs and computes in float32 or bfloat16")
    return policy


class MultiLayerNetwork(nn.Module):
    def __init__(self, conf_or_layers, *, device="cuda", dtype_policy=None):
        """A net from a `MultiLayerConfiguration` (its layers become the
        net's, as in JAX, and the conf stays as `.conf`) or from a list
        of layer modules (a `.conf` is made from them, so the net can be
        written). A conf whose layers already belong to a net is copied
        first, so two nets never share params. Params are zeros (LayerNorm
        gains ones) until `init` draws them or a loader fills them."""
        super().__init__()
        if isinstance(conf_or_layers, MultiLayerConfiguration):
            conf = conf_or_layers
            if any(getattr(l, "_in_net", False) for l in conf.layers):
                conf = MultiLayerConfiguration.from_dict(conf.to_dict())
        else:
            conf = MultiLayerConfiguration(layers=list(conf_or_layers))
        for layer in conf.layers:
            layer._in_net = True
        self.conf = conf
        self.layers = nn.ModuleList(conf.layers)
        # DL4J_DTYPE_POLICY env > explicit arg > conf.dtype_policy >
        # process default
        self.dtype = _check_policy(resolve_policy(dtype_policy, conf))
        self.device = resolve_device(device)
        super().to(self.device)
        self.iteration_count = 0
        self.epoch_count = 0
        self.score_value = float("nan")
        self.params_version = 0
        # {"<layer>": {param name: updater state}}, keyed like the JAX
        # net's `updater_state` (Adam: {"m", "v"}; Sgd: {})
        self.updater_state: Dict[str, Dict[str, Dict[str, torch.Tensor]]] = {
            str(i): {name: self.updater_of(layer).init_state(t)
                     for name, t in layer.jax_param_map().items()}
            for i, layer in enumerate(self.layers) if layer.jax_param_map()}

    def init(self, seed: Optional[int] = None) -> "MultiLayerNetwork":
        """Draw every layer's params, in layer order, from one CPU
        `torch.Generator` seeded with `seed` (default `conf.seed`); the
        JAX package's draws are threefry bits, which this does not
        reproduce (load those with `util.jax_params`)."""
        gen = torch.Generator().manual_seed(
            self.conf.seed if seed is None else int(seed))
        for layer in self.layers:
            layer.init_weights(gen)
        self.params_changed()
        return self

    def params_changed(self):
        """Note a write of the params: caches keyed on `params_version`
        (the serving trees) rebuild at their next use."""
        self.params_version += 1

    def load_state_dict(self, *args, **kwargs):
        out = super().load_state_dict(*args, **kwargs)
        self.params_changed()
        return out

    def to(self, device):
        """Move every parameter, buffer and updater state to `device`
        (resolved like an entry point's `device=`)."""
        self.device = resolve_device(device)
        super().to(self.device)
        self.params_changed()
        self.updater_state = {
            lk: {pk: {sk: t.to(self.device) for sk, t in st.items()}
                 for pk, st in lst.items()}
            for lk, lst in self.updater_state.items()}
        return self

    @staticmethod
    def updater_of(layer):
        return layer.updater or Sgd(1e-3)

    def init_carries(self, batch: int) -> Dict[str, object]:
        return {str(i): layer.init_carry(batch, self.dtype.compute_dtype,
                                         self.device)
                for i, layer in enumerate(self.layers)
                if isinstance(layer, BaseRecurrentLayer)}

    # ----------------------------------------------------------- forward
    def _forward(self, x, carries: Optional[Dict[str, object]] = None,
                 upto: Optional[int] = None):
        """The forward through layers [0, upto). Without carries: each
        layer's full-sequence `forward`. With carries (streaming decode
        / prefill): recurrent layers run `forward_with_carry` from
        `carries[str(i)]` (their fresh carry when absent). Returns
        (h, new_carries)."""
        if not isinstance(self.layers[0], EmbeddingLayer):
            # token ids pass uncast: a bf16 round corrupts ids above 256
            x = self.dtype.cast_compute(x)
        h = x
        new_carries = {}
        pre = self.conf.input_preprocessors
        for i, layer in enumerate(self.layers[:upto]):
            if i in pre:
                h = pre[i].pre_process(h)
            if carries is not None and isinstance(layer, BaseRecurrentLayer):
                carry = carries.get(str(i))
                if carry is None:
                    carry = layer.init_carry(h.shape[0],
                                             self.dtype.compute_dtype,
                                             self.device)
                h, new_carries[str(i)] = layer.forward_with_carry(h, carry)
            else:
                h = layer(h)
        return h, new_carries

    @torch.no_grad()
    def _forward_core(self, x, carries: Optional[Dict[str, object]] = None):
        """The inference forward (no autograd): scoring, generate() and
        serving. Returns (h, new_carries)."""
        return self._forward(x, carries)

    @torch.no_grad()
    def output(self, x):
        """Forward pass to the final activation (the JAX `output`, no
        mask): token ids [B, T] -> [B, T, V] softmax for the LM, in the
        output dtype (fp32). Arrays take `fit`'s feature path (float-
        carried ids are checked and made int64); tensors pass as they
        are."""
        x = (x.to(self.device) if isinstance(x, torch.Tensor)
             else self._features(x))
        return self.dtype.cast_output(
            self._policy_call(lambda: self._forward(x)[0]))

    # --------------------------------------------------- the dtype policy
    def forward(self, fn, *args):
        """`fn(*args)`: the module call `torch.func.functional_call`
        makes, so `_policy_call` can run any of the container's own
        functions with the params swapped for their compute copies."""
        return fn(*args)

    def _compute_copies(self, requires_grad: bool) -> Dict[str, torch.Tensor]:
        """One compute-dtype copy of each floating param, keyed by its
        qualified name (a param shared by two layers is one entry)."""
        cd = self.dtype.compute_dtype
        return {n: p.detach().to(cd).requires_grad_(requires_grad)
                for n, p in self.named_parameters() if p.is_floating_point()}

    def _policy_call(self, fn, *args, copies=None, output_params=False):
        """`fn(*args)` under the policy. Not mixed: as is, on the fp32
        params. Mixed: on `copies` (fresh ones without grad when None),
        installed for the call; with `output_params` the output layer's
        copies enter upcast to the output dtype, as the loss takes them."""
        if not self.dtype.is_mixed:
            return fn(*args)
        if current_sequence_mesh() is not None and any(
                getattr(m, "sequence_parallel", None) for m in self.modules()):
            raise NotImplementedError(
                "ring and Ulysses attention under a mixed dtype policy are "
                "not ported yet; train them under float32")
        if copies is None:
            copies = self._compute_copies(requires_grad=False)
        installed = dict(copies)
        if output_params:
            prefix = f"layers.{len(self.layers) - 1}."
            for n, t in copies.items():
                if n.startswith(prefix):
                    installed[n] = self.dtype.cast_output(t)
        return torch.func.functional_call(self, installed, (fn, *args),
                                          strict=False)

    # --------------------------------------------------------------- loss
    def _loss_fn(self, x, y):
        """The output layer's loss on the forward through the layers
        before it (the JAX `_loss_fn` without diagnostics, MoE aux loss
        or weight noise; regularization is zero)."""
        out = self.layers[-1]
        if not isinstance(out, BaseOutputLayerMixin):
            raise ValueError(f"the last layer ({type(out).__name__}) has no "
                             f"loss; fit needs an output layer")
        self._check_trainable()
        h, _ = self._forward(x, upto=len(self.layers) - 1)
        # the loss stays in the output dtype (identity when not mixed)
        h, y = self.dtype.cast_output(h), self.dtype.cast_output(y)
        return self.dtype.cast_output(out.compute_loss(h, y))

    def _check_trainable(self):
        """Refuse the configured fields that act in training and are not
        ported: `fit` and `score` would silently compute something else.
        Each is inert at inference, so `output()`, `generate()` and
        serving accept them (a zip trained with dropout can be served)."""
        c, bad = self.conf, []
        if c.max_norm is not None:
            bad.append("max_norm")
        gn = GradientNormalization(c.gradient_normalization)
        if gn != GradientNormalization.NONE:
            bad.append(f"gradient_normalization {gn.value}")
        if BackpropType(c.backprop_type) == BackpropType.TRUNCATED_BPTT:
            bad.append("backprop_type tbptt")
        if c.pretrain:
            bad.append("pretrain")
        if c.optimization_algo != "sgd":
            bad.append(f"optimization_algo {c.optimization_algo}")
        if c.diagnostics is not None:
            bad.append("diagnostics")
        for i, layer in enumerate(self.layers):
            for f in ("dropout", "attention_dropout", "weight_noise"):
                if getattr(layer, f, None) is not None:
                    bad.append(f"layer {i} {f}")
            if layer.constraints:
                bad.append(f"layer {i} constraints")
            for f in ("l1", "l2", "l1_bias", "l2_bias"):
                if getattr(layer, f):
                    bad.append(f"layer {i} {f} (l1/l2 regularization)")
        if bad:
            raise NotImplementedError(
                f"not ported yet for training: {', '.join(bad)} (ROADMAP "
                f"Queue 1 items 5, 6 and 10)")

    # ------------------------------------------------------------ updates
    def _packed_runs(self) -> List[List[int]]:
        """Maximal runs of >= MIN_RUN structurally identical consecutive
        layers with params, the output layer excluded (the JAX
        `scan_stack.build_layer_plan` over n - 1 layers)."""
        runs, i, n = [], 0, len(self.layers) - 1
        while i < n:
            sig = layer_signature(self.layers[i])
            j = i + 1
            if sig is not None:
                while j < n and layer_signature(self.layers[j]) == sig:
                    j += 1
            if j - i >= MIN_RUN:
                runs.append(list(range(i, j)))
            i = j
        return runs

    def _update_groups(self) -> List[List[int]]:
        """Layers that share one update: each packed run, and each other
        layer with params on its own, in layer order."""
        runs = self._packed_runs()
        in_run = {i for r in runs for i in r}
        return sorted(runs + [[i] for i, layer in enumerate(self.layers)
                              if i not in in_run and layer.jax_param_map()])

    @torch.no_grad()
    def _apply_updates(self, step: int, grads=None):
        """One update of every param (the JAX `_apply_updates`) from
        `grads` ({id(param): gradient}; None: each param's `.grad`; a
        param without one gets a zero gradient in the compute dtype): an
        Adam group is one fused-Adam call over all its leaves (one kernel
        launch on the card, bf16 gradients onto the fp32 state under
        mixed_bf16); any other rule applies per leaf. Grads are upcast to
        the param dtype."""
        cd = self.dtype.compute_dtype
        for group in self._update_groups():
            updater = self.updater_of(self.layers[group[0]])
            ps, gs, states = [], [], []
            for i in group:
                for name, p in self.layers[i].jax_param_map().items():
                    g = p.grad if grads is None else grads.get(id(p))
                    ps.append(p)
                    gs.append(torch.zeros_like(p, dtype=cd) if g is None
                              else g)
                    states.append(self.updater_state[str(i)][name])
            if type(updater) is Adam:
                adam_update_packed(updater, ps, gs,
                                   [s["m"] for s in states],
                                   [s["v"] for s in states], step)
                continue
            for p, g, st in zip(ps, gs, states):
                upd, new = updater.apply(g.to(p.dtype), st, step)
                p.sub_(upd.to(p.dtype))
                st.update(new)
        self.params_changed()

    # ---------------------------------------------------------------- fit
    def _features(self, x) -> torch.Tensor:
        """Features on the net's device. Token ids for an embedding
        input may arrive float-carried (the JAX fit takes
        `X.astype(np.float32)`): they are checked to be whole and in
        range, then made int64 on the host."""
        x = np.asarray(x)
        first = self.layers[0]
        if isinstance(first, EmbeddingLayer):
            if x.dtype.kind == "f" and not np.array_equal(x, np.round(x)):
                raise ValueError("token ids must be whole numbers")
            if x.size and (x.min() < 0 or x.max() >= first.n_in):
                raise ValueError(f"token ids must be in [0, {first.n_in}); "
                                 f"got [{x.min()}, {x.max()}]")
            return torch.as_tensor(x.astype(np.int64), device=self.device)
        return torch.as_tensor(x, dtype=self.dtype.param_dtype,
                               device=self.device)

    def _labels(self, y) -> torch.Tensor:
        return torch.as_tensor(np.asarray(y), dtype=self.dtype.output_dtype,
                               device=self.device)

    def _loss_and_grads(self, x, y):
        """The loss on one minibatch and {id(param): gradient}. fp32: the
        params take gradients for this call only. Mixed: the gradients
        of this step's compute copies (bf16), the params untouched."""
        if self.dtype.is_mixed:
            copies = self._compute_copies(requires_grad=True)
            loss = self._policy_call(self._loss_fn, x, y, copies=copies,
                                     output_params=True)
            loss.backward()
            return loss.detach(), {id(p): copies[n].grad
                                   for n, p in self.named_parameters()
                                   if n in copies}
        params = list(self.parameters())
        try:
            for p in params:
                p.requires_grad_(True)
            loss = self._loss_fn(x, y)
            loss.backward()
            return loss.detach(), {id(p): p.grad for p in params}
        finally:
            for p in params:
                p.requires_grad_(False)
                p.grad = None

    def _fit_step(self, x, y):
        """forward + loss + backward + update on one minibatch."""
        loss, grads = self._loss_and_grads(x, y)
        self._apply_updates(self.iteration_count, grads)
        self.score_value = float(loss)
        self.iteration_count += 1

    def fit(self, data, labels=None, *, epochs: int = 1, batch_size: int = 32,
            data_format=None, shuffle: bool = True,
            steps_per_execution: int = 1):
        """Train (the JAX `fit`): `data` is an `ArrayDataSetIterator`, a
        `DataSet` or a feature array with `labels`. One step per
        minibatch; `iteration_count` is the updater's step. The port's
        net has no truncated-BPTT or line-search-solver setting: it
        always takes plain backprop steps."""
        if int(steps_per_execution) != 1:
            raise NotImplementedError(
                "steps_per_execution > 1 (fused multi-step) is not ported")
        if data_format not in (None, "native"):
            raise NotImplementedError(f"data_format {data_format!r} is not "
                                      f"ported")
        iterator = as_iterator(data, labels, batch_size=batch_size,
                               shuffle=shuffle)
        for _ in range(int(epochs)):
            for ds in iterator:
                if ds.labels is None:
                    raise ValueError("fit needs labels")
                self._fit_step(self._features(ds.features),
                               self._labels(ds.labels))
            self.epoch_count += 1
        return self

    @torch.no_grad()
    def score(self, dataset=None) -> float:
        """The loss on `dataset` (a `DataSet`), or the last fit
        minibatch's score without one."""
        if dataset is None:
            return self.score_value
        return float(self._policy_call(
            self._loss_fn, self._features(dataset.features),
            self._labels(dataset.labels), output_params=True))
