"""What the two containers share (`nn/multilayer.py`'s MultiLayerNetwork
and `nn/graph.py`'s ComputationGraph): params and state, the dtype
policy, the loss's regularization, the update, the fit loop, scoring
and evaluation.

A container holds its layers in an `nn.ModuleList`, `layers`, beside
`layer_keys`, the JAX net's key of each ("<i>" for a layer list, the
node name in a graph), so `updater_state`, `net_state`, `param_table`
and the carriers (`util/jax_params`, `util/serializer`) are keyed as
the JAX net's trees. `fold_ids[key]` is the index `init(seed)` and the
train step fold the layer's threefry key with (its position in a list,
its node's position in the graph's topological order), so `init` draws
JAX's weights and training JAX's masks.

Training (`_fit_step`) runs in the JAX train step's order: the forward
to the output layers (each layer's weight noise installed for its
forward), their losses plus the l1/l2 penalty, `backward()`, gradient
normalization per layer, the updates, each layer's constraints, then
`max_norm` over every param, and last the running state the forward
computed (BatchNormalization's). Params take gradients only inside the
step. The packed runs (`_packed_runs`: maximal runs of at least
`MIN_RUN` structurally identical stateless layers with params, never an
output layer) are the JAX package's: an Adam run is ONE fused-Adam
update, and no run packs where the configuration keeps JAX from packing
(`scan_stack.packable_runs`: a per-layer or per-param-type norm mode,
`max_norm`, a constrained run, `scan_layers` off). Updates happen in
place.

Dtype policy (`nd/dtype.py`, the JAX `self.dtype`): under a mixed
policy such as `mixed_bf16` each step makes ONE compute-dtype copy of
every floating param, outside the differentiated function, and runs
`fit`'s forward, `score()` and `output()` on those copies through
`torch.func.functional_call` (the JAX containers cast the param tree
once and differentiate the cast tree). So the gradients are bf16, the
params and the updater state stay the fp32 master, and the updater
upcasts each gradient. The output layers' params are the copies
rounded to bf16 and upcast again, so the loss is fp32. Buffers (the
running state) stay fp32.

Params version: `params_version` counts the writes of the params
(`_apply_updates`, `init`, `to`, `load_state_dict`, and through
`params_changed()` the carriers). Caches keyed on it (the serving
trees) rebuild at their next use. Running-state writes do not count:
no cache reads the state.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    create_selective_checkpoint_contexts,
)

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
)
from deeplearning4j_tpu_torch.nn.layers.feedforward import EmbeddingLayer
from deeplearning4j_tpu_torch.optimize.gradients import (
    apply_gradient_normalization,
    apply_max_norm_constraint,
)
from deeplearning4j_tpu_torch.optimize.listeners import ComposedListeners

MIN_RUN = 2          # shortest run of identical layers that packs
WEIGHT_NOISE_FOLD = 0x5EED   # a layer key's weight-noise fold (JAX's)
# gradient-normalization modes that see the same numbers through a
# packed run (elementwise, or none): the JAX `scan_stack.SAFE_PACK_GN`
SAFE_PACK_GN = (GradientNormalization.NONE,
                GradientNormalization.CLIP_ELEMENTWISE_ABSOLUTE_VALUE)


# the ops whose results `remat_policy="dots_saveable"` keeps: JAX's
# `checkpoint_policies.dots_saveable` keeps the dot_general results
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def effective_remat_policy(layer) -> Optional[str]:
    """The policy the containers apply to `layer` in training (the JAX
    `scan_stack.effective_remat_policy`): its `remat_policy` ("none" is
    None), else "full" for the transformer block's legacy `remat`."""
    policy = getattr(layer, "remat_policy", None)
    if policy not in (None, "none"):
        return policy
    return "full" if getattr(layer, "remat", False) else None


def layer_signature(layer):
    """Structural identity of a layer that can join a packed run (None
    for one without params or with running state), as the JAX
    `scan_stack.layer_signature` and `stackable` have it: its class, its
    whole configuration (`to_dict()`: updater, dropout, weight noise,
    constraints and all) and its params' names, shapes and dtypes."""
    pmap = layer.jax_param_map()
    if (not pmap or layer.state_map()
            or not getattr(layer, "stackable_params", True)):
        return None
    conf = json.dumps(layer.to_dict(), sort_keys=True, default=str)
    shapes = tuple(sorted((k, tuple(t.shape), str(t.dtype))
                          for k, t in pmap.items()))
    return type(layer).__name__, conf, shapes


def scan_enabled(conf) -> bool:
    """The JAX `scan_stack.scan_enabled`: `scan_layers`, unless
    `DL4J_SCAN_LAYERS` turns it off. Runs pack only where it holds."""
    env = os.environ.get("DL4J_SCAN_LAYERS")
    if env is not None and env.strip().lower() in ("0", "false", "off",
                                                   "no"):
        return False
    return bool(getattr(conf, "scan_layers", True))


def check_policy(policy: DataTypePolicy) -> DataTypePolicy:
    """The policies the port runs: fp32 master params and fp32 outputs,
    compute in fp32 or bf16 (the kernels' two dtypes)."""
    if (policy.param_dtype != torch.float32
            or policy.output_dtype != torch.float32
            or policy.compute_dtype not in (torch.float32, torch.bfloat16)):
        raise NotImplementedError(
            f"dtype policy {policy.to_dict()} is not ported: the port keeps "
            f"fp32 params and outputs and computes in float32 or bfloat16")
    return policy


class Container(nn.Module):
    """The shared base; a subclass sets up `conf`, `layers`, `layer_keys`
    and `fold_ids` through `_setup` and supplies the forward, the loss,
    the candidate runs and the feature conversion."""

    def _setup(self, conf, layers, keys, fold_ids, device, dtype_policy):
        for layer in layers:
            layer._in_net = True
        self.conf = conf
        self.layers = nn.ModuleList(layers)
        self.layer_keys = list(keys)
        self.fold_ids = dict(fold_ids)
        # DL4J_DTYPE_POLICY env > explicit arg > conf.dtype_policy >
        # process default
        self.dtype = check_policy(resolve_policy(dtype_policy, conf))
        self.device = resolve_device(device)
        nn.Module.to(self, self.device)
        self.iteration_count = 0
        self.epoch_count = 0
        self.listeners = []
        self.score_value = float("nan")
        self.params_version = 0
        self._solver = None      # the fit's line-search Solver, if any
        # {key: {param name: updater state}}, keyed like the JAX net's
        # `updater_state` (Adam: {"m", "v"}; Sgd: {})
        self.updater_state: Dict[str, Dict[str, Dict[str, torch.Tensor]]] = {
            key: {name: self.updater_of(layer).init_state(t)
                  for name, t in layer.jax_param_map().items()}
            for key, layer in self.keyed() if layer.jax_param_map()}

    def keyed(self):
        return zip(self.layer_keys, self.layers)

    @property
    def net_state(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """{key: {state name: buffer}} of the stateful layers, the JAX
        net's `net_state` (BatchNormalization's running mean and var)."""
        return {key: layer.state_map() for key, layer in self.keyed()
                if layer.state_map()}

    def init(self, seed: Optional[int] = None):
        """Draw every layer's params as the JAX `_init_trees` does: layer
        `key` under ``fold_in(PRNGKey(seed), fold_ids[key])`` (its
        position in a list, its node's in the graph's topological order;
        `seed` defaults to `conf.seed`), and reset the running state. The
        draws are made on the net's device."""
        root = prng.key(self.conf.seed if seed is None else int(seed))
        for key, layer in self.keyed():
            layer.init_weights(prng.fold_in(root, self.fold_ids[key]))
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
        nn.Module.to(self, self.device)
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

    def num_params(self) -> int:
        return sum(t.numel() for _, layer in self.keyed()
                   for t in layer.jax_param_map().values())

    def param_table(self) -> Dict[str, torch.Tensor]:
        """{"<key>_<param>": tensor}, in the JAX names and layouts."""
        return {f"{key}_{pk}": t for key, layer in self.keyed()
                for pk, t in layer.jax_param_map().items()}

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

    def _call_layer(self, key, layer, h, *, train, rng, mask, new_state):
        """`layer` on h with its key `fold_in(rng, fold id)` and weight
        noise; a stateful layer in training leaves its next running
        state in `new_state[key]`. In training a layer's remat policy
        applies (`_remat`)."""
        lrng = None if rng is None else prng.fold_in(rng, self.fold_ids[key])
        kw = {}
        if new_state is not None and (layer.state_map()
                                      or layer.emits_aux_loss):
            kw["new_state"] = new_state.setdefault(key, {})
        policy = effective_remat_policy(layer) if train else None
        if policy is not None and torch.is_grad_enabled():
            return self._remat(layer, policy, h, lrng, mask, kw)
        with self._weight_noise(layer, train, lrng):
            return layer(h, train=train, rng=lrng, mask=mask, **kw)

    def _remat(self, layer, policy, h, lrng, mask, kw):
        """The training call of `layer` under `torch.utils.checkpoint`
        (the JAX `scan_stack.layer_forward` :99-110). "full" keeps only
        the layer's input and recomputes the whole layer in the backward;
        "dots_saveable" keeps the results of the matmul ops (`aten.mm`,
        `addmm`, `bmm`) and recomputes everything else, the flash forward
        included. The recompute sees the tensors of the forward: the
        layer's params as they are now (a mixed step's bf16 copies, which
        `functional_call` installs only for the forward) are passed in,
        the weight noise is redrawn inside and the step key rides the
        closure, so the numbers are those of the call without remat."""
        params = dict(layer.named_parameters())

        def body(x):
            with self._weight_noise(layer, True, lrng):
                return torch.func.functional_call(
                    layer, params, (x,), dict(train=True, rng=lrng,
                                              mask=mask, **kw),
                    strict=False)
        extra = {}
        if policy == "dots_saveable":
            extra["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts, _save_dots)
        return torch.utils.checkpoint.checkpoint(
            body, h, use_reentrant=False, **extra)

    def _call_with_carry(self, key, layer, h, carry, *, train, rng, mask):
        """A recurrent `layer` on h from `carry` (its fresh carry in h's
        dtype when None), with its key and weight noise as in
        `_call_layer`. Returns (y, new carry)."""
        lrng = None if rng is None else prng.fold_in(rng, self.fold_ids[key])
        if carry is None:
            carry = layer.init_carry(h.shape[0], h.dtype, h.device)
        with self._weight_noise(layer, train, lrng):
            return layer.forward_with_carry(h, carry, mask, train=train,
                                            rng=lrng)

    def _output_loss(self, key, layer, h, y, mask, *, train, rng):
        """The output layer's loss in the output dtype (identity when not
        mixed) on h, with its key and weight noise; `mask` is the label
        mask."""
        lrng = None if rng is None else prng.fold_in(rng, self.fold_ids[key])
        h, y = self.dtype.cast_output(h), self.dtype.cast_output(y)
        with self._weight_noise(layer, train, lrng):
            return layer.compute_loss(h, y, mask=mask, train=train, rng=lrng)

    def _mask(self, mask) -> Optional[torch.Tensor]:
        """A features or label mask ([B, T] or [B], 1 where real) as fp32
        on the net's device (None stays None)."""
        if mask is None:
            return None
        if isinstance(mask, torch.Tensor):
            return mask.to(self.device, torch.float32)
        return torch.as_tensor(np.asarray(mask), dtype=torch.float32,
                               device=self.device)

    def _features_for(self, x, first) -> torch.Tensor:
        """Features on the net's device for the layer `first` that takes
        them. Token ids for an embedding may arrive float-carried (the
        JAX fit takes `X.astype(np.float32)`): they are checked to be
        whole and in range, then made int64 on the host."""
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        x = np.asarray(x)
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
        if isinstance(y, torch.Tensor):
            return y.to(self.device, self.dtype.output_dtype)
        return torch.as_tensor(np.asarray(y), dtype=self.dtype.output_dtype,
                               device=self.device)

    # --------------------------------------------------- the dtype policy
    def forward(self, fn, *args):
        """`fn(*args)`: the module call `torch.func.functional_call`
        makes, so `_policy_call` can run any of the container's own
        functions with the params swapped for their compute copies."""
        return fn(*args)

    def _compute_copies(self, requires_grad: bool) -> Dict[str, torch.Tensor]:
        """One compute-dtype copy of each floating param, keyed by its
        qualified name (a param shared by two layers is one entry); a
        copy keeps its param's memory layout."""
        cd = self.dtype.compute_dtype
        return {n: p.detach().to(cd).requires_grad_(requires_grad)
                for n, p in self.named_parameters() if p.is_floating_point()}

    def _output_positions(self) -> List[int]:
        """Positions in `layers` of the layers whose loss `fit` takes."""
        raise NotImplementedError

    def _policy_call(self, fn, *args, copies=None, output_params=False):
        """`fn(*args)` under the policy. Not mixed: as is, on the fp32
        params. Mixed: on `copies` (fresh ones without grad when None),
        installed for the call; with `output_params` the output layers'
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
            prefixes = tuple(f"layers.{i}." for i in self._output_positions())
            for n, t in copies.items():
                if n.startswith(prefixes):
                    installed[n] = self.dtype.cast_output(t)
        return torch.func.functional_call(self, installed, (fn, *args),
                                          strict=False)

    # --------------------------------------------------------------- loss
    def _regularization(self):
        """The l1/l2 penalty of every layer's params (the JAX `_loss_fn`),
        on the params in the compute dtype: JAX sums it over the cast
        tree (the output layers' too, before their upcast)."""
        cd, reg = self.dtype.compute_dtype, 0.0
        for layer in self.layers:
            if not (layer.l1 or layer.l2 or layer.l1_bias or layer.l2_bias):
                continue
            params = layer.jax_param_map()
            if params:
                reg = reg + layer.regularization_score(
                    {k: t.to(cd) for k, t in params.items()})
        return reg

    @staticmethod
    def _pop_aux(new_state):
        """The sum of the auxiliary losses a training forward left in
        `new_state` (MixtureOfExperts' load balance), popped so they
        never persist (the JAX `_loss_fn`); 0.0 when there are none."""
        aux = 0.0
        for st in (new_state or {}).values():
            if "aux_loss" in st:
                aux = aux + st.pop("aux_loss")
        return aux

    def _refusals(self) -> List[str]:
        """The configured fields that act in training and are not ported
        (`fit` and `score` would silently compute something else): the
        diagnostics, which wait for `monitor/`. Inert at inference, so
        `output()` accepts them. The `pretrain` flag is inert in `fit`,
        as in JAX: layerwise pretraining is the `pretrain()` method."""
        return ["diagnostics"] if self.conf.diagnostics is not None else []

    def _check_trainable(self):
        bad = self._refusals()
        if bad:
            raise NotImplementedError(
                f"not ported yet for training: {', '.join(bad)} (ROADMAP "
                f"Queue 1 item 5)")

    # ------------------------------------------------------------ updates
    def _candidate_runs(self) -> List[List[int]]:
        """Maximal runs (positions in `layers`) of >= MIN_RUN layers with
        one `layer_signature`, as the JAX forward scans them."""
        raise NotImplementedError

    def _packed_runs(self) -> List[List[int]]:
        """The candidate runs kept where JAX packs them
        (`scan_stack.packable_runs`): none under a per-layer or
        per-param-type gradient normalization, with `max_norm` or with
        `scan_layers` off, and no run whose layers have constraints."""
        c = self.conf
        if (GradientNormalization(c.gradient_normalization)
                not in SAFE_PACK_GN or c.max_norm is not None
                or not scan_enabled(c)):
            return []
        return [r for r in self._candidate_runs()
                if not self.layers[r[0]].constraints]

    def _update_groups(self, packed: bool = True) -> List[List[int]]:
        """Layers that share one update: each packed run (none when not
        `packed`), and each other layer with params on its own, in layer
        order."""
        runs = self._packed_runs() if packed else []
        in_run = {i for r in runs for i in r}
        return sorted(runs + [[i] for i, layer in enumerate(self.layers)
                              if i not in in_run and layer.jax_param_map()])

    def _layer_tree(self, by_id) -> Dict[str, Dict[str, torch.Tensor]]:
        """{layer key: {JAX name: by_id[id(param)]}} over the layers with
        params (a missing gradient is a zero in the compute dtype)."""
        cd = self.dtype.compute_dtype
        tree = {}
        for key, layer in self.keyed():
            params = layer.jax_param_map()
            if params:
                tree[key] = {
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
        return {id(p): tree[key][name]
                for key, layer in self.keyed()
                for name, p in layer.jax_param_map().items()}

    @torch.no_grad()
    def _apply_updates(self, step: int, grads=None, packed: bool = True):
        """One update of every param (the JAX `_apply_updates`) from
        `grads` ({id(param): gradient}; None: each param's `.grad`; a
        param without one gets a zero gradient in the compute dtype): an
        Adam run is one fused-Adam call over all its leaves (one kernel
        launch on the card, bf16 gradients onto the fp32 state under
        mixed_bf16); any other group applies its rule per leaf. Grads
        are upcast to the param dtype. Then each layer's constraints and
        `max_norm`, written into the params in place. A truncated-BPTT
        chunk updates unpacked (`packed=False`), as JAX's TBPTT step
        does."""
        cd = self.dtype.compute_dtype
        for group in self._update_groups(packed):
            updater = self.updater_of(self.layers[group[0]])
            ps, gs, states = [], [], []
            for i in group:
                key = self.layer_keys[i]
                for name, p in self.layers[i].jax_param_map().items():
                    g = p.grad if grads is None else grads.get(id(p))
                    ps.append(p)
                    gs.append(torch.zeros_like(p, dtype=cd) if g is None
                              else g)
                    states.append(self.updater_state[key][name])
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
        for key, layer in self.keyed():
            params = layer.jax_param_map()
            if params:
                trees[key] = layer.apply_constraints(dict(params))
        if self.conf.max_norm is not None:
            trees = apply_max_norm_constraint(trees, self.conf.max_norm)
        for key, layer in self.keyed():
            for name, p in layer.jax_param_map().items():
                new = trees[key][name]
                if new is not p:
                    p.copy_(new)

    @torch.no_grad()
    def _commit_state(self, new_state):
        """Write the running state a training forward computed (after
        the step's update, as the JAX step returns it)."""
        for key, layer in self.keyed():
            st = new_state.get(key)
            if st:
                for name, buf in layer.state_map().items():
                    buf.copy_(st[name])

    # ---------------------------------------------------------------- fit
    def _loss_and_grads(self, loss_fn):
        """`loss_fn(new_state)`'s training loss on one minibatch,
        {id(param): gradient} and the running state it computed. fp32:
        the params take gradients for this call only. Mixed: the
        gradients of this step's compute copies (bf16), the params
        untouched."""
        new_state = {}
        if self.dtype.is_mixed:
            copies = self._compute_copies(requires_grad=True)
            loss = self._policy_call(loss_fn, new_state, copies=copies,
                                     output_params=True)
            loss.backward()
            return loss.detach(), {id(p): copies[n].grad
                                   for n, p in self.named_parameters()
                                   if n in copies}, new_state
        params = list(self.parameters())
        try:
            for p in params:
                p.requires_grad_(True)
            loss = loss_fn(new_state)
            loss.backward()
            return loss.detach(), {id(p): p.grad for p in params}, new_state
        finally:
            for p in params:
                p.requires_grad_(False)
                p.grad = None

    def _step_key(self, iteration: int):
        """The threefry key of training step `iteration`: JAX's
        `fold_in(PRNGKey(seed + 1), iteration)`."""
        return prng.fold_in(prng.key(self.conf.seed + 1), iteration)

    def _train_step(self, x, y, fmask, lmask, iteration: int):
        """forward + loss + backward + gradient normalization + update +
        constraints + running state on one minibatch at training step
        `iteration` (truncated BPTT when configured and the features
        carry a time axis). Returns the loss, a tensor on the device
        (a float under truncated BPTT); the counters are the caller's."""
        rng = self._step_key(iteration)
        T = self._tbptt_time(x)
        if T is not None:
            return self._fit_tbptt(x, y, fmask, lmask, rng, T, iteration)
        loss, grads, new_state = self._loss_and_grads(
            lambda st: self._loss_fn(x, y, fmask, lmask, train=True,
                                     rng=rng, new_state=st))
        self._apply_updates(iteration, self._normalize_gradients(grads))
        self._commit_state(new_state)
        return loss

    def _fit_step(self, x, y, fmask=None, lmask=None):
        """One training step at `iteration_count` (a line-search solver's
        `optimize` of the minibatch when one is configured), its score
        read back; the fit loop moves the count on after the step's
        listener calls, as JAX's does."""
        if self._solver is not None:
            self.score_value = self._solver.optimize(x, y, fmask, lmask)
        else:
            self.score_value = float(self._train_step(
                x, y, fmask, lmask, self.iteration_count))

    # ------------------------------------------------------ truncated BPTT
    def _is_tbptt(self) -> bool:
        return (BackpropType(self.conf.backprop_type)
                == BackpropType.TRUNCATED_BPTT)

    def _tbptt_time(self, x) -> Optional[int]:
        """The time extent truncated BPTT chunks, or None for a plain
        step (not configured, or no [B, T, F] features)."""
        raise NotImplementedError

    def _recurrent_keys(self) -> List[str]:
        from deeplearning4j_tpu_torch.nn.layers.recurrent import (
            BaseRecurrentLayer)
        return [k for k, layer in self.keyed()
                if isinstance(layer, BaseRecurrentLayer)]

    def stream_budget(self) -> Optional[int]:
        """The smallest KV-cache / positional length of the net's layers
        (`nn.layers.stream_budget`), or None."""
        from deeplearning4j_tpu_torch.nn.layers.transformer import (
            stream_budget)
        return stream_budget(list(self.layers))

    def init_carries(self, batch: int) -> Dict[str, object]:
        """Every recurrent layer's fresh carry in the compute dtype."""
        layers = dict(self.keyed())
        return {k: layers[k].init_carry(batch, self.dtype.compute_dtype,
                                        self.device)
                for k in self._recurrent_keys()}

    def _fit_tbptt(self, x, y, fmask, lmask, rng, T: int,
                   iteration: int) -> float:
        """Truncated BPTT (the JAX `_fit_tbptt`, MultiLayerNetwork
        :838-876 and ComputationGraph :1024-1066): the time axis in
        chunks of `tbptt_fwd_length`, each chunk one step (its key
        `fold_in(rng, s)` at chunk start s, ONE updater step at the same
        iteration index for every chunk, updated unpacked), every
        recurrent layer's carry threaded from chunk to chunk with its
        gradient stopped. Returns the mean of the chunk losses."""
        budget = self.stream_budget()
        if budget is not None and T > budget:
            raise ValueError(
                f"TBPTT over a {T}-step sequence exceeds the bounded "
                f"carry budget {budget} (min over transformer cache_len "
                f"/ positional max_len): chunks past the budget would "
                f"silently clamp into the KV cache. Shorten the "
                f"sequences or rebuild with cache_len/max_len >= {T}.")
        L = int(self.conf.tbptt_fwd_length)
        carries = self.init_carries(self._batch_of(x))
        total, n = 0.0, 0
        for s in range(0, T, L):
            xc, yc, fm, lm = self._chunk(x, y, fmask, lmask, s, L)
            crng = prng.fold_in(rng, s)
            stopped = _detach(carries)
            out = {}
            loss, grads, new_state = self._loss_and_grads(
                lambda st: self._loss_fn(xc, yc, fm, lm, train=True,
                                         rng=crng, new_state=st,
                                         carries=stopped, carries_out=out))
            self._apply_updates(iteration, self._normalize_gradients(grads),
                                packed=False)
            self._commit_state(new_state)
            carries = {**carries, **out}
            total += float(loss)
            n += 1
        return total / max(n, 1)

    def _batch_of(self, x) -> int:
        raise NotImplementedError

    def _chunk(self, x, y, fmask, lmask, s: int, L: int):
        raise NotImplementedError

    # --------------------------------------------------- rnn streaming
    def rnn_clear_previous_state(self):
        """Forget the carries `rnn_time_step` keeps."""
        self._rnn_carries = {}
        self._rnn_stream_pos = 0

    def _check_stream_budget(self, new_tokens: int):
        """The JAX bounded-carry guard: streaming past a KV cache or a
        positional table would silently clamp, so it raises."""
        budget = self.stream_budget()
        pos = getattr(self, "_rnn_stream_pos", 0)
        if budget is not None and pos + new_tokens > budget:
            raise ValueError(
                f"rnn_time_step has streamed {pos} positions and this call "
                f"adds {new_tokens}, exceeding the stream budget {budget} "
                f"(min over transformer cache_len / positional max_len). "
                f"Call rnn_clear_previous_state() to start a new sequence, "
                f"or rebuild with a larger cache_len/max_len.")

    def _stream(self, fn, batch: int, t_new: int):
        """`fn(carries)` -> (out, new carries) from the kept carries
        (fresh ones for the recurrent layers without one), under the
        policy and without autograd; keeps the new carries."""
        self._check_stream_budget(t_new)
        carries = {**self.init_carries(batch),
                   **getattr(self, "_rnn_carries", {})}
        with torch.no_grad():
            out, new = self._policy_call(fn, carries)
        self._rnn_carries = {**carries, **new}
        self._rnn_stream_pos = getattr(self, "_rnn_stream_pos", 0) + t_new
        return out

    # ----------------------------------------------------------- pretrain
    def _pretrain_targets(self):
        """[(layer key, layer)] of the layers `pretrain` trains, in the
        order it trains them."""
        raise NotImplementedError

    def _pretrain_features(self, key, features) -> torch.Tensor:
        """The input of layer `key` for a minibatch's features: the net
        below it in inference mode, without autograd."""
        raise NotImplementedError

    def pretrain(self, data, *, epochs: int = 1, batch_size: int = 32):
        """Greedy layerwise pretraining (the JAX `pretrain`): each layer
        with a `pretrain_loss` (AutoEncoder, RBM, VariationalAutoencoder),
        in order, takes `epochs` passes of `data` (arrays, a DataSet or
        an iterator; labels unused) through the layers below it in
        inference mode. Step `it` of the layer at fold index i draws under
        ``fold_in(PRNGKey(seed + 2), it * 997 + i)``; the updater is the
        layer's (`Sgd(1e-3)` when None) with a fresh state and `it`
        counted from 0 for each layer. No l1/l2, gradient normalization,
        constraints or dropout apply. Each step's loss stays on the
        device in `pretrain_losses[key]`. Returns the net."""
        iterator = as_iterator(data, batch_size=batch_size)
        root = prng.key(self.conf.seed + 2)
        self.pretrain_losses = {}
        for key, layer in self._pretrain_targets():
            fold = self.fold_ids[key]
            updater = self.updater_of(layer)
            params = layer.jax_param_map()
            state = {n: updater.init_state(t) for n, t in params.items()}
            it = 0
            for _ in range(int(epochs)):
                for ds in iterator:
                    h = self._pretrain_features(key, ds.features)
                    rng = prng.fold_in(root, it * 997 + fold)
                    self.pretrain_losses.setdefault(key, []).append(
                        self._pretrain_step(layer, params, state, updater,
                                            h, rng, it))
                    it += 1
            self.params_changed()
        return self

    def _pretrain_step(self, layer, params, state, updater, h, rng,
                       it: int):
        """One update of `layer`'s params on `pretrain_loss(h, rng)`;
        returns the loss."""
        try:
            for p in params.values():
                p.requires_grad_(True)
            loss = layer.pretrain_loss(h, rng)
            loss.backward()
            with torch.no_grad():
                for n, p in params.items():
                    g = p.grad if p.grad is not None else torch.zeros_like(p)
                    upd, new = updater.apply(g, state[n], it)
                    p.sub_(upd.to(p.dtype))
                    state[n].update(new)
            return loss.detach()
        finally:
            for p in params.values():
                p.requires_grad_(False)
                p.grad = None

    def _set_solver(self):
        """`_solver`: the `Solver` of a line-search `optimization_algo`,
        made at the first fit and kept, as JAX keeps it (None for sgd);
        refused with truncated BPTT, as in JAX
        (`nn/multilayer.py:701-708`)."""
        algo = self.conf.optimization_algo
        if algo == "sgd":
            self._solver = None
            return
        if self._is_tbptt():
            raise ValueError(
                "optimization_algo=%r cannot be combined with truncated "
                "BPTT: the line-search solvers optimize the full-sequence "
                "loss and would ignore tbptt_fwd_length. Use SGD, or "
                "standard backprop_type." % algo)
        if self._solver is None or self._solver.algorithm.value != algo:
            from deeplearning4j_tpu_torch.optimize.solvers import Solver
            self._solver = Solver(self, algo,
                                  max_iterations=self.conf.max_iterations,
                                  device=self.device)

    def _batch(self, ds, data_format):
        """(x, y, {"fmask", "lmask"}) of a minibatch on the device, the
        features and labels converted from `data_format`."""
        raise NotImplementedError

    def _fit_iterator(self, iterator, epochs: int,
                      steps_per_execution: int = 1, data_format=None):
        """The fit loop (the JAX `fit`): one step per minibatch, with its
        features and label masks; `iteration_count` is the updater's
        step and the step key's fold. Listeners get `on_fit_start`,
        `on_epoch_start`, `iteration_done` after each step (with the
        step's iteration; the count moves on after the call, as in JAX),
        `on_epoch_end` and `on_fit_end`. An iterator with `reset()` is
        reset at each epoch's start, as JAX does.

        `steps_per_execution` k > 1 groups k unmasked minibatches of one
        shape: the k steps run back to back with the numbers of per-step
        fit, their losses stay on the device and are read back once
        after the group (JAX reads the stacked losses of its fused scan
        once), then the k `iteration_done` calls follow, each with its
        iteration and score; only the last carries `step_boundary=True`
        (the earlier ones see the group's final params, as in JAX). A
        masked batch, a change of shape, the epoch's ragged tail, a
        line-search solver and truncated BPTT go per step, where JAX
        falls back too."""
        self._set_solver()
        spe = max(1, int(steps_per_execution))
        grouped = spe > 1 and self._solver is None and not self._is_tbptt()
        listeners = ComposedListeners(self.listeners)

        def one(item, etl_ms):
            x, y, masks, n, raw = item
            self._fit_step(x, y, **masks)
            listeners.iteration_done(
                self, self.iteration_count, self.epoch_count,
                self.score_value, batch_size=n, etl_ms=etl_ms, batch=raw)
            self.iteration_count += 1

        def flush(pending, etl_ms):
            if len(pending) == 1:
                one(pending[0], etl_ms)
            elif pending:
                it0 = self.iteration_count
                losses = torch.stack([
                    torch.as_tensor(self._train_step(x, y, None, None,
                                                     it0 + j)).float()
                    for j, (x, y, _, _, _) in enumerate(pending)]).cpu()
                for j, (_, _, _, n, raw) in enumerate(pending):
                    self.score_value = float(losses[j])
                    listeners.iteration_done(
                        self, self.iteration_count, self.epoch_count,
                        self.score_value, batch_size=n,
                        etl_ms=etl_ms if j == 0 else 0.0, batch=raw,
                        step_boundary=j == len(pending) - 1)
                    self.iteration_count += 1
            pending.clear()

        listeners.on_fit_start(self)
        for _ in range(int(epochs)):
            listeners.on_epoch_start(self, self.epoch_count)
            if hasattr(iterator, "reset"):
                iterator.reset()
            batches, pending = iter(iterator), []
            while True:
                t0 = time.perf_counter()
                ds = next(batches, None)
                if ds is None:
                    break
                etl_ms = (time.perf_counter() - t0) * 1e3
                x, y, masks = self._batch(ds, data_format)
                item = (x, y, masks, ds.num_examples(),
                        (ds.features, ds.labels,
                         getattr(ds, "features_mask", None),
                         getattr(ds, "labels_mask", None)))
                if not grouped or masks:
                    flush(pending, 0.0)
                    one(item, etl_ms)
                    continue
                if pending and _shapes(pending[0][:2]) != _shapes(item[:2]):
                    flush(pending, 0.0)
                pending.append(item)
                if len(pending) == spe:
                    flush(pending, etl_ms)
            flush(pending, 0.0)
            listeners.on_epoch_end(self, self.epoch_count)
            self.epoch_count += 1
        listeners.on_fit_end(self)
        return self

    # ------------------------------------------------- params and state
    def set_param_table(self, table: Dict[str, object]):
        """Write {"<key>_<param>": array} into the params in place (the
        JAX `set_param_table`; a key splits at its first "_")."""
        params = dict(self.keyed())
        with torch.no_grad():
            for name, arr in table.items():
                lk, pk = name.split("_", 1)
                p = params[lk].jax_param_map()[pk]
                src = torch.as_tensor(np.asarray(arr) if not isinstance(
                    arr, torch.Tensor) else arr)
                if tuple(src.shape) != tuple(p.shape):
                    raise ValueError(f"{name}: shape {tuple(src.shape)} "
                                     f"where the param is {tuple(p.shape)}")
                p.copy_(src.to(p.device, p.dtype))
        self.params_changed()
        return self

    def copy(self):
        """A clone with its own tensors (the JAX `copy`): the same
        configuration, dtype policy and device, the params, running
        state and updater state copied, the counters and score kept.
        Updates happen in place here, so a clone that shared a tensor
        would move the original when it trains."""
        clone = type(self)(type(self.conf).from_dict(self.conf.to_dict()),
                           device=self.device, dtype_policy=self.dtype)
        with torch.no_grad():
            for (_, a), (_, b) in zip(self.keyed(), clone.keyed()):
                for name, t in a.jax_param_map().items():
                    b.jax_param_map()[name].copy_(t)
                for name, t in a.state_map().items():
                    b.state_map()[name].copy_(t)
        clone.updater_state = {
            lk: {pk: {sk: t.detach().clone() for sk, t in st.items()}
                 for pk, st in lst.items()}
            for lk, lst in self.updater_state.items()}
        clone.iteration_count = self.iteration_count
        clone.epoch_count = self.epoch_count
        clone.score_value = self.score_value
        clone.params_changed()
        return clone

    @classmethod
    def resume(cls, directory, *, device="cuda", iterator=None):
        """The net of the newest valid full-state checkpoint under
        `directory` (`fault.resume`): params, updater state, running
        state and counters restored under the recorded dtype policy, so
        a follow-up `fit()` continues the interrupted run bit for bit
        (the step key derives from the restored iteration count). A
        corrupt newer checkpoint falls back to an older one with a
        logged warning. `iterator` is moved to the stored cursor."""
        from deeplearning4j_tpu_torch import fault
        model, _ = fault.resume(directory, device=device, iterator=iterator)
        if not isinstance(model, cls):
            raise TypeError(
                f"checkpoint under {directory} holds a "
                f"{type(model).__name__}; use that container's resume()")
        return model

    # --------------------------------------------------------- evaluation
    def _eval_output(self, features, features_mask, data_format=None):
        raise NotImplementedError

    def _evaluate_with(self, evaluator, iterator, data_format=None):
        """Accumulate `evaluator.eval(labels, output, mask=labels mask)`
        over the iterator (the JAX `_evaluate_with`): the output with the
        features mask (features from `data_format`), batches of 128 from
        arrays."""
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
        iterator = as_iterator(iterator, batch_size=128)
        if hasattr(iterator, "reset"):
            iterator.reset()
        for ds in iterator:
            out = self._eval_output(ds.features, ds.features_mask,
                                    data_format)
            kw = {}
            meta = getattr(ds, "example_metadata", None)
            if meta is not None and isinstance(evaluator, Evaluation):
                kw["record_metadata"] = meta
            evaluator.eval(ds.labels, out.cpu().numpy(),
                           mask=ds.labels_mask, **kw)
        return evaluator

    def evaluate(self, iterator, labels_list=None, top_n: int = 1, *,
                 data_format=None):
        """Classification metrics (the JAX `evaluate`)."""
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
        return self._evaluate_with(
            Evaluation(labels_names=labels_list, top_n=top_n), iterator,
            data_format)

    def evaluate_roc(self, iterator, threshold_steps: int = 0, *,
                     data_format=None):
        """Binary ROC over the iterator (the JAX `evaluate_roc`)."""
        from deeplearning4j_tpu_torch.eval.roc import ROC
        return self._evaluate_with(ROC(threshold_steps=threshold_steps),
                                   iterator, data_format)

    def evaluate_roc_multi_class(self, iterator, threshold_steps: int = 0,
                                 *, data_format=None):
        """One-vs-all ROC per class (the JAX
        `evaluate_roc_multi_class`)."""
        from deeplearning4j_tpu_torch.eval.roc import ROCMultiClass
        return self._evaluate_with(
            ROCMultiClass(threshold_steps=threshold_steps), iterator,
            data_format)

    def evaluate_regression(self, iterator, *, data_format=None):
        from deeplearning4j_tpu_torch.eval.regression import (
            RegressionEvaluation)
        return self._evaluate_with(RegressionEvaluation(), iterator,
                                   data_format)


def convert_features(x, data_format):
    """Features from `data_format` into the native layout (the JAX
    `_convert_features`): NCHW -> NHWC, NCW/NFT [B, F, T] -> [B, T, F];
    None and "native" pass. Arrays stay arrays, tensors tensors."""
    if data_format in (None, "native"):
        return x
    fmt = data_format.upper()
    if fmt == "NCHW":
        perm = (0, 2, 3, 1)
    elif fmt in ("NCW", "NFT"):
        perm = (0, 2, 1)
    else:
        raise ValueError(f"Unknown data_format {data_format}")
    if isinstance(x, torch.Tensor):
        return x.permute(*perm)
    return np.transpose(np.asarray(x), perm)


def convert_labels(y, data_format):
    """Labels from `data_format` (the JAX `_convert_labels`): rank-3
    NCW/NFT labels become [B, T, F]; everything else passes."""
    if y is None or data_format in (None, "native"):
        return y
    if data_format.upper() in ("NCW", "NFT") and np.ndim(y) == 3:
        return (y.permute(0, 2, 1) if isinstance(y, torch.Tensor)
                else np.transpose(np.asarray(y), (0, 2, 1)))
    return y


def _shapes(tensors):
    """The shapes of a minibatch's features and labels (each a tensor or
    a list of them)."""
    return [tuple(t.shape) for part in tensors
            for t in (part if isinstance(part, (list, tuple)) else [part])]


def _detach(tree):
    """The carries with every tensor detached (ints, such as a stream
    position, pass)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_detach(v) for v in tree)
    return tree
