"""MultiLayerNetwork — the sequential container (counterpart of
`deeplearning4j_tpu/nn/multilayer.py`: `_forward_core` :210, `_loss_fn`
:322, `_packed_runs` :378, `_apply_updates` :410, `_make_train_step`
:479, `fit` :678, `output` :878, `feed_forward` :894, `score` :902,
`evaluate*` :915-963).

Layers live in an `nn.ModuleList` in the JAX net's order, so layer `i`
here is layer `i` there and `util.jax_params` can load the JAX net's
`{"<i>": {name: array}}` params and updater state directly. PyTorch
runs eagerly: there is no jit, no scan-over-layers and no pytree — the
forward is a Python loop over the layers.

Inference (`output()`, `generate()`, serving) runs `_forward_core`
under `no_grad`. Training (`fit`) runs the same loop with autograd, in
the JAX train step's order: the forward to the output layer (each
layer's weight noise installed for its forward), the output layer's
loss plus the l1/l2 penalty, `backward()`, gradient normalization per
layer, the updates, each layer's constraints, then `max_norm` over
every param. Params take gradients only inside the train step. Maximal
runs of at least `MIN_RUN` structurally identical layers (the LM's
blocks; never the output layer) are the JAX package's packed runs: an
Adam run is ONE fused-Adam update. A layer outside a run updates per
leaf, and so does every run when the configuration keeps JAX from
packing (`scan_stack.packable_runs`: a per-layer or per-param-type norm
mode, `max_norm`, or a constrained run). Updates happen in place.

Randomness is JAX's (`common/prng.py`): the step's key is
`fold_in(key(seed + 1), iteration)`, layer i's `fold_in(step key, i)`,
its weight noise `fold_in(layer key, 0x5EED)`, and each layer folds
further as its JAX layer does, so dropout and weight noise draw JAX's
masks bit for bit (the dropout kernel on the card).

Masks: `fit` takes features and label masks from a `DataSet` or an
iterator, `output(mask=)`, `feed_forward(mask=)` and `score()` a
features mask; each layer's `forward_mask` carries it to the next, and
the loss takes the label mask, or the carried mask without one.

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

Listeners (`optimize/listeners.py`): `set_listeners`/`add_listener`;
`fit` calls `on_fit_start`, `on_epoch_start`, `iteration_done` after
each step (with the step's iteration, before the count moves on),
`on_epoch_end` and `on_fit_end`, as the JAX fit loop does.

Not ported yet, and refused rather than ignored: steps_per_execution >
1, `data_format`, and, in `fit` and `score` (`_check_trainable`),
truncated BPTT, `pretrain`, a line-search `optimization_algo`,
diagnostics and `WeightNoise` over a distribution other than normal or
uniform.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from deeplearning4j_tpu_torch.common import prng
from deeplearning4j_tpu_torch.common.updaters import Adam, Sgd
from deeplearning4j_tpu_torch.datasets.iterator import as_iterator
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.kernels.fused_adam import adam_update_packed
from deeplearning4j_tpu_torch.nd import quant
from deeplearning4j_tpu_torch.nd.dtype import DataTypePolicy, resolve_policy
from deeplearning4j_tpu_torch.nn.conf.builder import (
    BackpropType,
    GradientNormalization,
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.weightnoise import WeightNoise
from deeplearning4j_tpu_torch.optimize.gradients import (
    apply_gradient_normalization,
    apply_max_norm_constraint,
)
from deeplearning4j_tpu_torch.optimize.listeners import ComposedListeners
from deeplearning4j_tpu_torch.nn.layers.feedforward import (
    BaseOutputLayerMixin,
    EmbeddingLayer,
)
from deeplearning4j_tpu_torch.nn.layers.recurrent import BaseRecurrentLayer

MIN_RUN = 2          # shortest run of identical layers that packs
WEIGHT_NOISE_FOLD = 0x5EED   # a layer key's weight-noise fold (JAX's)
# gradient-normalization modes that see the same numbers through a
# packed run (elementwise, or none): the JAX `scan_stack.SAFE_PACK_GN`
SAFE_PACK_GN = (GradientNormalization.NONE,
                GradientNormalization.CLIP_ELEMENTWISE_ABSOLUTE_VALUE)


def layer_signature(layer):
    """Structural identity of a layer with params (None without), as the
    JAX `scan_stack.layer_signature` has it: its class, its whole
    configuration (`to_dict()`: updater, dropout, weight noise,
    constraints and all) and its params' names, shapes and dtypes."""
    pmap = layer.jax_param_map()
    if not pmap:
        return None
    conf = json.dumps(layer.to_dict(), sort_keys=True, default=str)
    shapes = tuple(sorted((k, tuple(t.shape), str(t.dtype))
                          for k, t in pmap.items()))
    return type(layer).__name__, conf, shapes


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
        self.listeners = []
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

    def set_listeners(self, *listeners):
        self.listeners = list(listeners)
        return self

    def add_listener(self, listener):
        self.listeners.append(listener)
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
    def _weight_noise(self, layer, train: bool, lrng):
        """Context: `layer`'s weight noise installed over its params for
        the block (the JAX `apply_weight_noise` before the layer's
        forward, keyed `fold_in(layer key, 0x5EED)`); nothing outside
        training or without noise."""
        if not train or layer.weight_noise is None or lrng is None:
            return contextlib.nullcontext()
        params = layer.jax_param_map()
        noised = layer.apply_weight_noise(
            params, train, prng.fold_in(lrng, WEIGHT_NOISE_FOLD))
        slots = layer.param_slots()
        return quant.overlaid({(id(m), a): noised[n]
                               for n, (m, a) in slots.items()
                               if noised[n] is not params[n]})

    def _forward(self, x, carries: Optional[Dict[str, object]] = None,
                 upto: Optional[int] = None, *, train: bool = False,
                 rng=None, mask=None, collect: Optional[list] = None):
        """The forward through layers [0, upto). Without carries: each
        layer's full-sequence `forward` with its key `fold_in(rng, i)`
        (None without `rng`) and the mask the layers before it carried.
        With carries (streaming decode / prefill): recurrent layers run
        `forward_with_carry` from `carries[str(i)]` (their fresh carry
        when absent). `collect` gets each layer's output appended.
        Returns (h, new_carries, mask)."""
        if not isinstance(self.layers[0], EmbeddingLayer):
            # token ids pass uncast: a bf16 round corrupts ids above 256
            x = self.dtype.cast_compute(x)
        h = x
        new_carries = {}
        pre = self.conf.input_preprocessors
        for i, layer in enumerate(self.layers[:upto]):
            if i in pre:
                h = pre[i].pre_process(h, mask)
            lrng = None if rng is None else prng.fold_in(rng, i)
            with self._weight_noise(layer, train, lrng):
                if carries is not None and isinstance(layer,
                                                      BaseRecurrentLayer):
                    carry = carries.get(str(i))
                    if carry is None:
                        carry = layer.init_carry(h.shape[0],
                                                 self.dtype.compute_dtype,
                                                 self.device)
                    h, new_carries[str(i)] = layer.forward_with_carry(
                        h, carry, mask=mask)
                else:
                    h = layer(h, train=train, rng=lrng, mask=mask)
            mask = layer.forward_mask(mask)
            if collect is not None:
                collect.append(h)
        return h, new_carries, mask

    @torch.no_grad()
    def _forward_core(self, x, carries: Optional[Dict[str, object]] = None):
        """The inference forward (no autograd): scoring, generate() and
        serving. Returns (h, new_carries)."""
        return self._forward(x, carries)[:2]

    def _mask(self, mask) -> Optional[torch.Tensor]:
        """A features or label mask ([B, T] or [B], 1 where real) as fp32
        on the net's device (None stays None)."""
        if mask is None:
            return None
        if isinstance(mask, torch.Tensor):
            return mask.to(self.device, torch.float32)
        return torch.as_tensor(np.asarray(mask), dtype=torch.float32,
                               device=self.device)

    def _inputs(self, x):
        return (x.to(self.device) if isinstance(x, torch.Tensor)
                else self._features(x))

    @torch.no_grad()
    def output(self, x, mask=None):
        """Forward pass to the final activation (the JAX `output`):
        token ids [B, T] -> [B, T, V] softmax for the LM, in the output
        dtype (fp32); `mask` [B, T] is the padding mask (1 where real).
        Arrays take `fit`'s feature path (float-carried ids are checked
        and made int64); tensors pass as they are."""
        x, mask = self._inputs(x), self._mask(mask)
        return self.dtype.cast_output(
            self._policy_call(lambda: self._forward(x, mask=mask)[0]))

    @torch.no_grad()
    def feed_forward(self, x, mask=None) -> List[torch.Tensor]:
        """Every layer's activation, in layer order (the JAX
        `feed_forward`: no dropout, in the compute dtype)."""
        x, mask, acts = self._inputs(x), self._mask(mask), []
        self._policy_call(lambda: self._forward(x, mask=mask, collect=acts))
        return acts

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
        copies enter upcast to the output dtype, as the loss takes them.
        Ring and Ulysses attention run on the installed bf16 copies as
        the local path does (fp32 flash-ring state, fp32 backward sums,
        results in the inputs' dtype)."""
        if not self.dtype.is_mixed:
            return fn(*args)
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
    def _regularization(self):
        """The l1/l2 penalty of every layer's params (the JAX `_loss_fn`
        :356-366), on the params in the compute dtype: JAX sums it over
        the cast tree (the output layer's too, before its upcast)."""
        cd, reg = self.dtype.compute_dtype, 0.0
        for layer in self.layers:
            if not (layer.l1 or layer.l2 or layer.l1_bias or layer.l2_bias):
                continue
            params = layer.jax_param_map()
            if params:
                reg = reg + layer.regularization_score(
                    {k: t.to(cd) for k, t in params.items()})
        return reg

    def _loss_fn(self, x, y, fmask=None, lmask=None, *, train=False,
                 rng=None):
        """The output layer's loss on the forward through the layers
        before it, plus the l1/l2 penalty (the JAX `_loss_fn` without
        diagnostics or the MoE aux loss). The label mask defaults to the
        mask the layers carried; the output layer's key is
        `fold_in(rng, n - 1)`."""
        out = self.layers[-1]
        if not isinstance(out, BaseOutputLayerMixin):
            raise ValueError(f"the last layer ({type(out).__name__}) has no "
                             f"loss; fit needs an output layer")
        self._check_trainable()
        n = len(self.layers)
        h, _, mask = self._forward(x, upto=n - 1, train=train, rng=rng,
                                   mask=fmask)
        lrng = None if rng is None else prng.fold_in(rng, n - 1)
        label_mask = lmask if lmask is not None else mask
        # the loss stays in the output dtype (identity when not mixed)
        h, y = self.dtype.cast_output(h), self.dtype.cast_output(y)
        with self._weight_noise(out, train, lrng):
            loss = out.compute_loss(h, y, mask=label_mask, train=train,
                                    rng=lrng)
        return self.dtype.cast_output(loss) + self._regularization()

    def _check_trainable(self):
        """Refuse the configured fields that act in training and are not
        ported: `fit` and `score` would silently compute something else.
        Each is inert at inference, so `output()`, `generate()` and
        serving accept them."""
        c, bad = self.conf, []
        if BackpropType(c.backprop_type) == BackpropType.TRUNCATED_BPTT:
            bad.append("backprop_type tbptt")
        if c.pretrain:
            bad.append("pretrain")
        if c.optimization_algo != "sgd":
            bad.append(f"optimization_algo {c.optimization_algo}")
        if c.diagnostics is not None:
            bad.append("diagnostics")
        for i, layer in enumerate(self.layers):
            wn = layer.weight_noise
            if isinstance(wn, WeightNoise) and not wn.dist.KEYED:
                bad.append(f"layer {i} weight_noise over "
                           f"{type(wn.dist).__name__}")
        if bad:
            raise NotImplementedError(
                f"not ported yet for training: {', '.join(bad)} (ROADMAP "
                f"Queue 1 items 6 and 10)")

    # ------------------------------------------------------------ updates
    def _packed_runs(self) -> List[List[int]]:
        """Maximal runs of >= MIN_RUN structurally identical consecutive
        layers with params, the output layer excluded and no input
        preprocessor inside (the JAX `scan_stack.build_layer_plan` over
        n - 1 layers), kept only where
        JAX packs them (`scan_stack.packable_runs`): none under a
        per-layer or per-param-type gradient normalization or with
        `max_norm`, and no run whose layers have constraints."""
        c = self.conf
        if (GradientNormalization(c.gradient_normalization)
                not in SAFE_PACK_GN or c.max_norm is not None):
            return []
        runs, i, n = [], 0, len(self.layers) - 1
        pre = self.conf.input_preprocessors
        while i < n:
            sig = layer_signature(self.layers[i])
            j = i + 1
            if sig is not None:
                while (j < n and j not in pre
                       and layer_signature(self.layers[j]) == sig):
                    j += 1
            if j - i >= MIN_RUN and not self.layers[i].constraints:
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

    def _layer_tree(self, by_id) -> Dict[str, Dict[str, torch.Tensor]]:
        """{layer key: {JAX name: by_id[id(param)]}} over the layers with
        params (a missing gradient is a zero in the compute dtype)."""
        cd = self.dtype.compute_dtype
        tree = {}
        for i, layer in enumerate(self.layers):
            params = layer.jax_param_map()
            if params:
                tree[str(i)] = {
                    name: (by_id.get(id(p)) if by_id.get(id(p)) is not None
                           else torch.zeros_like(p, dtype=cd))
                    for name, p in params.items()}
        return tree

    def _normalize_gradients(self, grads):
        """{id(param): gradient} after the configured gradient
        normalization (per layer key, in the gradients' dtype)."""
        c = self.conf
        gn = GradientNormalization(c.gradient_normalization)
        if gn == GradientNormalization.NONE:
            return grads
        tree = apply_gradient_normalization(
            self._layer_tree(grads), gn, c.gradient_normalization_threshold)
        return {id(p): tree[str(i)][name]
                for i, layer in enumerate(self.layers)
                for name, p in layer.jax_param_map().items()}

    @torch.no_grad()
    def _apply_updates(self, step: int, grads=None):
        """One update of every param (the JAX `_apply_updates`) from
        `grads` ({id(param): gradient}; None: each param's `.grad`; a
        param without one gets a zero gradient in the compute dtype): an
        Adam run is one fused-Adam call over all its leaves (one kernel
        launch on the card, bf16 gradients onto the fp32 state under
        mixed_bf16); any other group applies its rule per leaf. Grads
        are upcast to the param dtype. Then each layer's constraints and
        `max_norm`, written into the params in place."""
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
            if type(updater) is Adam and len(group) > 1:
                adam_update_packed(updater, ps, gs,
                                   [s["m"] for s in states],
                                   [s["v"] for s in states], step)
                continue
            for p, g, st in zip(ps, gs, states):
                upd, new = updater.apply(g.to(p.dtype), st, step)
                p.sub_(upd.to(p.dtype))
                st.update(new)
        self._apply_constraints()
        self.params_changed()

    def _apply_constraints(self):
        """Each layer's constraints, then the global `max_norm`, on the
        updated params (in place)."""
        trees = {}
        for i, layer in enumerate(self.layers):
            params = layer.jax_param_map()
            if params:
                trees[str(i)] = layer.apply_constraints(dict(params))
        if self.conf.max_norm is not None:
            trees = apply_max_norm_constraint(trees, self.conf.max_norm)
        for i, layer in enumerate(self.layers):
            for name, p in layer.jax_param_map().items():
                new = trees[str(i)][name]
                if new is not p:
                    p.copy_(new)

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

    def _loss_and_grads(self, x, y, fmask=None, lmask=None, rng=None):
        """The training loss on one minibatch and {id(param): gradient}.
        fp32: the params take gradients for this call only. Mixed: the
        gradients of this step's compute copies (bf16), the params
        untouched."""
        def loss_fn():
            return self._loss_fn(x, y, fmask, lmask, train=True, rng=rng)

        if self.dtype.is_mixed:
            copies = self._compute_copies(requires_grad=True)
            loss = self._policy_call(loss_fn, copies=copies,
                                     output_params=True)
            loss.backward()
            return loss.detach(), {id(p): copies[n].grad
                                   for n, p in self.named_parameters()
                                   if n in copies}
        params = list(self.parameters())
        try:
            for p in params:
                p.requires_grad_(True)
            loss = loss_fn()
            loss.backward()
            return loss.detach(), {id(p): p.grad for p in params}
        finally:
            for p in params:
                p.requires_grad_(False)
                p.grad = None

    def _step_key(self, iteration: int):
        """The threefry key of training step `iteration`: JAX's
        `fold_in(PRNGKey(seed + 1), iteration)`."""
        return prng.fold_in(prng.key(self.conf.seed + 1), iteration)

    def _fit_step(self, x, y, fmask=None, lmask=None):
        """forward + loss + backward + gradient normalization + update +
        constraints on one minibatch."""
        loss, grads = self._loss_and_grads(
            x, y, fmask, lmask, self._step_key(self.iteration_count))
        self._apply_updates(self.iteration_count,
                            self._normalize_gradients(grads))
        self.score_value = float(loss)
        self.iteration_count += 1

    def fit(self, data, labels=None, *, epochs: int = 1, batch_size: int = 32,
            data_format=None, shuffle: bool = True,
            steps_per_execution: int = 1):
        """Train (the JAX `fit`): `data` is an iterator of `DataSet`s, a
        `DataSet` (or a list of them), or a feature array with `labels`.
        One step per minibatch, with its features and label masks;
        `iteration_count` is the updater's step and the step key's fold.
        The port's net has no truncated-BPTT or line-search-solver
        setting: it always takes plain backprop steps."""
        if int(steps_per_execution) != 1:
            raise NotImplementedError(
                "steps_per_execution > 1 (fused multi-step) is not ported")
        if data_format not in (None, "native"):
            raise NotImplementedError(f"data_format {data_format!r} is not "
                                      f"ported")
        iterator = as_iterator(data, labels, batch_size=batch_size,
                               shuffle=shuffle)
        listeners = ComposedListeners(self.listeners)
        listeners.on_fit_start(self)
        for _ in range(int(epochs)):
            listeners.on_epoch_start(self, self.epoch_count)
            batches = iter(iterator)
            while True:
                t0 = time.perf_counter()
                ds = next(batches, None)
                if ds is None:
                    break
                etl_ms = (time.perf_counter() - t0) * 1e3
                if ds.labels is None:
                    raise ValueError("fit needs labels")
                masks = {k: self._mask(m) for k, m in (
                    ("fmask", ds.features_mask), ("lmask", ds.labels_mask))
                    if m is not None}
                self._fit_step(self._features(ds.features),
                               self._labels(ds.labels), **masks)
                listeners.iteration_done(
                    self, self.iteration_count - 1, self.epoch_count,
                    self.score_value,
                    batch_size=int(np.shape(ds.features)[0]),
                    etl_ms=etl_ms, batch=(ds.features, ds.labels,
                                          ds.features_mask, ds.labels_mask))
            listeners.on_epoch_end(self, self.epoch_count)
            self.epoch_count += 1
        listeners.on_fit_end(self)
        return self

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

    # --------------------------------------------------------- evaluation
    def _evaluate_with(self, evaluator, iterator):
        """Accumulate `evaluator.eval(labels, output, mask=labels mask)`
        over the iterator (the JAX `_evaluate_with`): the output with the
        features mask, batches of 128 from arrays."""
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
        for ds in as_iterator(iterator, batch_size=128):
            out = self.output(ds.features, mask=ds.features_mask)
            kw = {}
            meta = getattr(ds, "example_metadata", None)
            if meta is not None and isinstance(evaluator, Evaluation):
                kw["record_metadata"] = meta
            evaluator.eval(ds.labels, out.cpu().numpy(),
                           mask=ds.labels_mask, **kw)
        return evaluator

    def evaluate(self, iterator, labels_list=None, top_n: int = 1):
        """Classification metrics (the JAX `evaluate`)."""
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
        return self._evaluate_with(
            Evaluation(labels_names=labels_list, top_n=top_n), iterator)

    def evaluate_roc(self, iterator, threshold_steps: int = 0):
        """Binary ROC over the iterator (the JAX `evaluate_roc`)."""
        from deeplearning4j_tpu_torch.eval.roc import ROC
        return self._evaluate_with(ROC(threshold_steps=threshold_steps),
                                   iterator)

    def evaluate_roc_multi_class(self, iterator, threshold_steps: int = 0):
        """One-vs-all ROC per class (the JAX
        `evaluate_roc_multi_class`)."""
        from deeplearning4j_tpu_torch.eval.roc import ROCMultiClass
        return self._evaluate_with(
            ROCMultiClass(threshold_steps=threshold_steps), iterator)

    def evaluate_regression(self, iterator):
        from deeplearning4j_tpu_torch.eval.regression import (
            RegressionEvaluation)
        return self._evaluate_with(RegressionEvaluation(), iterator)
