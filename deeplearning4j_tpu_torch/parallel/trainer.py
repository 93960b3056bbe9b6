"""ParallelTrainer: data-parallel training over a mesh's data axis
(counterpart of `deeplearning4j_tpu/parallel/trainer.py`).

One controller drives every replica, as JAX's single-controller
`shard_map`/GSPMD programs do: the global batch splits in equal row
blocks, block r goes to replica r on its mesh device, and each replica
runs the container's own forward and backward (`_loss_fn`, the kernels
of its layers) on its rows. The exchange reduces across replicas in
replica order (`parallel/collectives.py`), so on a mesh that repeats
one card the replicas run one after the other and the result is that
of N devices, not its speed.

Modes, each with JAX's semantics:

- sync, single barrier (`bucketed=False`, and multi-input or
  multi-output graphs in dense): JAX's GSPMD program is ONE step over
  the global batch, so its dropout draws under the global key over the
  global shape and BatchNorm normalizes with the global batch's
  statistics; the port runs the container's step on the global batch
  the same way (the reduction is the mean inside the loss).
- sync, bucketed (the default) and the rs modes: per-replica programs.
  Replica r draws under ``fold_in(step key, r)`` and normalizes with
  its shard's statistics; the float running state is the replica mean.
  dense: gradients meaned, then the container's own update (fused Adam
  over each packed run). threshold: each replica's own updater state
  and error-feedback residual, one τ per bucket
  (`gradient_sharing.bucket_plan`). dense_rs: the dense reduction, then
  every replica updates its last-axis shard of each sharded leaf with
  its shard of the updater state, the same elementwise kernels on
  shards, so its params and state equal dense's bit for bit.
  threshold_rs: the raw gradient encoded, the updater on the decoded
  shard.
- averaging: every replica holds its own params, updater state and
  running state (one container per replica), trains `averaging_frequency`
  local steps under ``fold_in(step key, r)``, then all of them are
  replaced by the replica mean (updater state too when
  `average_updater_state`).

The step key is JAX's ``fold_in(PRNGKey(seed + 3), iteration)``. The
model keeps replica 0's view; the per-replica stacks (threshold's
updater states and residual, averaging's trees) ride checkpoints in
JAX's layout (`_live_state_provider`, `_restore_fault_state`), so each
package resumes what the other wrote, elastically across replica
counts. With `stats` every timed phase synchronizes the card.

Diagnostics: the dense modes run the container's `_update` ("fit"
rows); threshold, threshold_rs and dense_rs run JAX's `_exchange_diag`
("exchange" rows: the post-exchange update and param statistics, the
error-feedback residual folded into the finite flags, and under the
``skip`` watchdog the whole step's params, updater state, residual, τ
and running state kept behind a device-side flag, no host sync);
averaging collects none, as JAX's local-SGD step does not.

Several processes (`parallel/multihost.py`): on a mesh that spans
processes each process drives the replicas it owns (`mesh.ranks`), and
every process passes the global batch, as JAX's global-view `fit`
does. Each reduction sums this process's replicas in replica order,
then across the processes on the data axis's group
(`collectives.CrossProcess`); the sharded rs leaves are gathered back
across processes after the shard updates, and the per-replica stacks a
checkpoint or `threshold_residual()` needs are gathered whole. The
single-barrier step runs each process's rows under
`common.global_batch.global_rows`, so dropout takes the global mask's
rows and BatchNorm the global batch's statistics.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.common import global_batch, prng
from deeplearning4j_tpu_torch.common.updaters import Adam
from deeplearning4j_tpu_torch.datasets.iterator import as_iterator
from deeplearning4j_tpu_torch.kernels.fused_adam import adam_update_packed
from deeplearning4j_tpu_torch.monitor.diagnostics import (
    keep_finite_,
    process_if_due,
    snapshot,
)
from deeplearning4j_tpu_torch.optimize.gradients import (
    apply_gradient_normalization,
)
from deeplearning4j_tpu_torch.optimize.listeners import ComposedListeners
from deeplearning4j_tpu_torch.parallel import collectives as coll
from deeplearning4j_tpu_torch.parallel import gradient_sharing as gs
from deeplearning4j_tpu_torch.parallel.mesh import data_devices, device_mesh
from deeplearning4j_tpu_torch.parallel.placement import ReplicaBatch

log = logging.getLogger(__name__)

_KIND = {"dense": "sync_dense", "threshold": "threshold",
         "dense_rs": "sync_dense_rs", "threshold_rs": "threshold_rs"}


def _rows(t, sl):
    if isinstance(t, (list, tuple)):
        return [a[sl] for a in t]
    return t[sl]


def _to(t, device):
    if isinstance(t, (list, tuple)):
        return [a.to(device) for a in t]
    return t.to(device)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _stack_host(trees):
    """Per-replica trees -> one host tree with a leading replica axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_host([t[k] for t in trees]) for k in first}
    return np.stack([t.detach().to("cpu").numpy() for t in trees])


def _unstack(tree, r, device):
    """Replica r's slice of a host stack, as tensors on `device`."""
    if isinstance(tree, dict):
        return {k: _unstack(v, r, device) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(np.asarray(tree)[r])).to(
        device)


def _copy_into(dst, src):
    """Copy a tree of tensors into the same-shaped tree in place."""
    with torch.no_grad():
        if isinstance(dst, dict):
            for k, v in dst.items():
                if k in src:
                    _copy_into(v, src[k])
        else:
            dst.copy_(src.to(dst.device, dst.dtype))


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def _require_single_process(what="mesh evaluate()"):
    """JAX's guard (`parallel/trainer.py:54-64`): the host readback needs
    every replica's output in this process."""
    from deeplearning4j_tpu_torch.parallel.multihost import process_count
    if process_count() > 1:
        raise NotImplementedError(
            f"{what} reads results back to one host and needs fully-"
            f"addressable arrays; under multi-process execution score "
            f"each process's local data shard on the host "
            f"(evaluator.eval(y, model.output(x)) per process) and "
            f"combine the evaluators with merge() — they all serialize "
            f"via to_json for the transport")


def _mesh_evaluate(iterator, merged, n_div, forward):
    """JAX's `_mesh_evaluate`: every batch through the replicas' forward,
    a ragged tail zero-padded to the data-axis multiple and the padded
    rows sliced off before scoring."""
    for ds in iterator:
        n = ds.num_examples()
        x = np.asarray(ds.features)
        if n % n_div != 0:
            pad = n_div - n % n_div
            x = np.concatenate(
                [x, np.zeros((pad,) + x.shape[1:], x.dtype)], axis=0)
        out = forward(x)[:n]
        merged.eval(np.asarray(ds.labels), out)
    return merged


def global_pass(model, x, y, rng, acts, offset, total, xp):
    """The container's forward and backward on this process's rows
    [offset, offset + len(x)) of a global batch of `total` rows: in one
    process (`xp` None) the container's own pass; across processes each
    runs its rows under `global_batch.global_rows` (the global dropout
    mask's rows, the global BatchNorm statistics), and the loss and the
    gradients are summed across the processes weighted by their rows,
    so every process holds the global batch's. Returns (loss,
    {id(param): gradient}, running state)."""
    def run():
        return model._loss_and_grads(
            lambda st: model._loss_fn(x, y, train=True, rng=rng,
                                      new_state=st, acts=acts))
    if xp is None:
        return run()
    with global_batch.global_rows(offset, total, xp):
        loss, grads, new_state = run()
    rows = (x[0] if isinstance(x, (list, tuple)) else x).shape[0]
    w = rows / total
    loss = loss.float() * w
    gl = [g for g in grads.values() if g is not None]
    for g in gl:
        g.mul_(w)
    xp.all_reduce_(gl + [loss])
    return loss, grads, new_state


class ParallelTrainer:
    def __init__(self, model, mesh=None, *, mode: str = "sync",
                 averaging_frequency: int = 5,
                 average_updater_state: bool = True, data_axis: str = "data",
                 gradient_sharing: Optional[str] = None,
                 threshold_config=None, stats=None,
                 bucketed: Optional[bool] = None, rs_param_specs=None):
        if mode not in ("sync", "averaging"):
            raise ValueError(f"mode must be sync|averaging, got {mode}")
        self.stats = stats
        self.model = model
        self.mesh = mesh if mesh is not None else device_mesh()
        self.mode = mode
        self.averaging_frequency = max(1, averaging_frequency)
        self.average_updater_state = average_updater_state
        self.data_axis = data_axis
        self.n_workers = int(self.mesh.shape[data_axis])
        # the replicas this process drives (all of them in one process):
        # their global indices and devices; `_xp` is the data axis's
        # cross-process step (None in one process)
        ranks = self.mesh.axis_ranks(data_axis)
        from deeplearning4j_tpu_torch.parallel.multihost import (
            process_index)
        me = process_index()
        self._rid = [r for r, rk in enumerate(ranks)
                     if rk is None or rk == me]
        everyone = data_devices(self.mesh, data_axis)
        self.devices = [everyone[r] for r in self._rid]
        self._xp = coll.make_axis_groups(self.mesh, data_axis)
        self.gradient_sharing = gs.resolve_mode(gradient_sharing, model.conf)
        if self.gradient_sharing != "dense" and mode != "sync":
            want = self.gradient_sharing
            if (gs.env_mode() == want
                    and (gradient_sharing or "dense") != want
                    and getattr(model.conf, "gradient_sharing",
                                "dense") != want):
                self.gradient_sharing = "dense"
            else:
                raise ValueError(
                    f"gradient_sharing={want!r} restructures the per-step "
                    "gradient exchange and only applies to mode='sync'; "
                    "averaging mode exchanges parameters, not gradients")
        if self.gradient_sharing in ("threshold", "threshold_rs"):
            gs.wire_dtype(self.n_workers)
        if (self.gradient_sharing in gs.RS_MODES
                and not gs.rs_supported_gn(model.conf)):
            raise ValueError(
                "the dense_rs/threshold_rs modes run gradient "
                "normalization on reduced gradient SHARDS and support "
                "only elementwise modes (none / "
                "clip_elementwise_absolute_value); this configuration's "
                f"{model.conf.gradient_normalization!r} needs whole-layer "
                "norms — use dense/threshold instead")
        self.bucketed = gs.resolve_bucketed(bucketed)
        self.rs_param_specs = rs_param_specs
        self._rs_plan_cache = None
        self.threshold_config = (threshold_config if threshold_config
                                 is not None
                                 else gs.ThresholdConfig.from_conf(
                                     model.conf))
        self._res_r = None        # per-replica residual trees (device)
        self._thr_tau = None      # {layer: f32} per bucket, or one scalar
        self._tau = None          # the step's τ on the device
        self._resume_upd_r = None  # host stacks from a checkpoint
        self._resume_res = None
        self._resume_avg = None
        self._replica_nets = None
        # the step key's seed offset and the trainer's name in
        # checkpoints and metrics (ShardedParallelTrainer's threshold
        # exchange runs through this trainer under its own)
        self._rng_offset = 3
        self._trainer_name = "parallel"
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
        self._is_graph = isinstance(model, ComputationGraph)
        self._multi_io_graph = self._is_graph and (
            len(model.conf.network_inputs) != 1
            or len(model.conf.network_outputs) != 1)

    # ------------------------------------------------------------ helpers
    def _params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {k: layer.jax_param_map() for k, layer in self.model.keyed()
                if layer.jax_param_map()}

    def _sync(self):
        for d in {str(d) for d in self.devices}:
            d = torch.device(d)
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def _nets(self):
        """One container per replica for the per-replica forward: the
        model where its device is the replica's, a copy on the replica's
        device elsewhere (averaging keeps a copy for every replica but
        0, whose params differ between rounds)."""
        if self._replica_nets is None:
            shared = self.mode != "averaging"
            self._replica_nets = [
                self.model if d == self.model.device and (r == 0 or shared)
                else self.model.copy().to(d)
                for r, d in enumerate(self.devices)]
        return self._replica_nets

    def _push_params(self):
        """Sync mode: the model's params (and running state) into the
        replicas on other devices (nothing on a repeated device)."""
        for net in self._nets():
            if net is not self.model:
                _copy_into(self._tree_of(net, "params"),
                           self._tree_of(self.model, "params"))
                _copy_into(net.net_state, self.model.net_state)
                net.params_changed()

    @staticmethod
    def _tree_of(net, what):
        if what == "params":
            return {k: layer.jax_param_map() for k, layer in net.keyed()
                    if layer.jax_param_map()}
        if what == "net_state":
            return net.net_state
        return net.updater_state

    def _by_id(self, tree):
        """{layer: {name: tensor}} -> {id(param): tensor} of the model."""
        return {id(p): tree[k][n] for k, layer in self.model.keyed()
                for n, p in layer.jax_param_map().items() if k in tree}

    def _replica_batches(self, ds):
        """[(r, x_r, y_r)] for this process's replicas (r the global
        replica index), each on its replica's device (a graph's as
        one-element lists)."""
        n = self.n_workers
        if isinstance(ds.features, ReplicaBatch):
            od = self.model.dtype.output_dtype
            wrap = (lambda t: [t]) if self._is_graph else (lambda t: t)
            return [(r, wrap(x), wrap(y.to(od))) for r, x, y in
                    zip(self._rid, ds.features.shards, ds.labels.shards)]
        x, y, _ = self.model._batch(ds, None)
        b = ds.num_examples() // n
        return [(r, _to(_rows(x, slice(r * b, (r + 1) * b)), d),
                 _to(_rows(y, slice(r * b, (r + 1) * b)), d))
                for r, d in zip(self._rid, self.devices)]

    def _global_batch(self, ds):
        if self._xp is not None:
            # this process's rows of the global batch
            x, y, _ = self.model._batch(ds, None)
            b = ds.num_examples() // self.n_workers
            sl = slice(self._rid[0] * b, (self._rid[-1] + 1) * b)
            return _rows(x, sl), _rows(y, sl)
        if isinstance(ds.features, ReplicaBatch):
            dev = self.model.device
            parts = self._replica_batches(ds)
            cat = (lambda ts: [torch.cat([t[0].to(dev) for t in ts])]) \
                if self._is_graph else (
                    lambda ts: torch.cat([t.to(dev) for t in ts]))
            return cat([p[0] for p in parts]), cat([p[1] for p in parts])
        x, y, _ = self.model._batch(ds, None)
        return x, y

    def _replica_pass(self, net, x, y, rng):
        """One replica's forward and backward on its rows: (loss, grads
        {layer: {name: tensor}}, running state)."""
        loss, grads, new_state = net._loss_and_grads(
            lambda st: net._loss_fn(x, y, train=True, rng=rng,
                                    new_state=st))
        return loss, net._layer_tree(grads), new_state

    # ------------------------------------------------ replica reductions
    def _cross(self, tensors):
        """Sum `tensors` across the data axis's processes, in place (a
        no-op in one process)."""
        if self._xp is not None and tensors:
            self._xp.all_reduce_(tensors)
        return tensors

    def _div(self, t):
        return t.div_(torch.tensor(self.n_workers, dtype=t.dtype,
                                   device=t.device))

    def _pmean_state(self, states):
        """The replicas' running states: float leaves meaned (this
        process's replicas in replica order, then across processes), the
        rest this process's first replica's (JAX's `_pmean_state`)."""
        dev = self.model.device
        out = {}
        for k, st in states[0].items():
            out[k] = {n: (coll.reduce_sum([s[k][n] for s in states], dev)
                          if t.is_floating_point() else t)
                      for n, t in st.items()}
        fl = [t for st in out.values() for t in st.values()
              if t.is_floating_point()]
        for t in self._cross(fl):
            self._div(t)
        return out

    def _loss_mean(self, losses):
        acc = coll.reduce_sum([l.float() for l in losses], self.model.device)
        self._cross([acc])
        return self._div(acc)

    def _full_stack(self, trees):
        """Every replica's tree as one host stack (leading replica axis):
        this process's, then, across processes, every process's in rank
        order (checkpoint cadence only)."""
        mine = _stack_host(trees)
        if self._xp is None:
            return mine
        parts = self._xp.all_gather_object(mine)

        def cat(ps):
            if isinstance(ps[0], dict):
                return {k: cat([p[k] for p in ps]) for k in ps[0]}
            return np.concatenate(ps, axis=0)
        return cat(parts)

    def _updater_state_floats(self) -> bool:
        return all(t.is_floating_point()
                   for lst in self.model.updater_state.values()
                   for st in lst.values() for t in st.values())

    def _rs_plan(self):
        if self._rs_plan_cache is None:
            self._rs_plan_cache = gs.rs_shard_plan(
                self._params(), self.n_workers, specs=self.rs_param_specs,
                data_axis=self.data_axis)
        return self._rs_plan_cache

    # ------------------------------------------------ exchange diagnostics
    def _diag_begin(self, upd_trees):
        """Before an exchange step with diagnostics on: the params'
        snapshot and, under ``skip``, the updater state, residual and τ
        the step is about to replace."""
        model = self.model
        if model._diag is None:
            return None
        params = self._params()
        flat = snapshot(_leaves(params))
        it = iter(flat)
        old = {lk: {pn: next(it) for pn in lp} for lk, lp in params.items()}
        kept = None
        if model._diag.config.watchdog == "skip":
            tau = self._tau
            kept = dict(
                upd=snapshot([t for u in upd_trees for t in _leaves(u)]),
                res=snapshot([t for r in (self._res_r or [])
                              for t in _leaves(r)]),
                tau=({k: v.clone() for k, v in tau.items()}
                     if isinstance(tau, dict) else
                     (tau.clone() if isinstance(tau, torch.Tensor)
                      else None)))
        return dict(old=old, kept=kept, upd_trees=upd_trees)

    @torch.no_grad()
    def _diag_end(self, ctx, loss, state_new, residual=True):
        """JAX's `_exchange_diag` (`parallel/gradient_sharing.py:378`):
        the post-exchange update and param statistics, the residual
        folded into the finite flags (summed over the replicas and the
        processes, as JAX's psum), and under ``skip`` the whole step
        undone behind the device-side flag: params, updater state,
        residual, τ and running state. Returns (vector, state to
        commit)."""
        if ctx is None:
            return None, state_new
        model = self.model
        params = self._params()
        res = self._res_r if residual else None
        dv, ok = model._diag.collect(
            "exchange", params_new=params, params_old=ctx["old"], loss=loss,
            extra_finite=res, xp=self._xp)
        kept = ctx["kept"]
        if kept is not None:
            keep_finite_(ok, _leaves(params), _leaves(ctx["old"]))
            keep_finite_(ok, [t for u in ctx["upd_trees"]
                              for t in _leaves(u)], kept["upd"])
            if res:
                keep_finite_(ok, [t for r in res for t in _leaves(r)],
                             kept["res"])
            if isinstance(self._tau, dict):
                self._tau = {k: torch.where(ok, v, kept["tau"][k])
                             for k, v in self._tau.items()}
            elif kept["tau"] is not None:
                self._tau = torch.where(ok, self._tau, kept["tau"])
            live = model.net_state
            state_new = {k: {n: (torch.where(ok, t, live[k][n])
                                 if n in live.get(k, {}) else t)
                             for n, t in st.items()}
                         for k, st in state_new.items()}
        return dv, state_new

    # ---------------------------------------------------------- sync steps
    def _step_global(self, it, ds, rng):
        """The single-barrier dense step: the container's step on the
        global batch (JAX's GSPMD program over the global batch); across
        processes each runs its rows of it (`global_pass`)."""
        model = self.model
        x, y = self._global_batch(ds)
        acts = model._act_stats()
        b = ds.num_examples() // self.n_workers
        loss, grads, new_state = global_pass(
            model, x, y, rng, acts, self._rid[0] * b, ds.num_examples(),
            self._xp)
        dv = model._update(it, model._normalize_gradients(grads), new_state,
                           loss, acts)
        self._push_params()
        return loss, dv, None

    def _reduced_grads(self, ds, rng):
        """Every replica's pass, the gradients meaned in replica order
        (their dtype; across processes after this process's sum), the
        running states and losses meaned."""
        dev = self.model.device
        nets = self._nets()
        acc, states, losses = None, [], []
        for j, (r, x, y) in enumerate(self._replica_batches(ds)):
            loss, g, st = self._replica_pass(nets[j], x, y,
                                             prng.fold_in(rng, r))
            losses.append(loss)
            states.append(st)
            if acc is None:
                acc = _map(lambda t: t.to(dev, copy=True), g)
            else:
                for k, lg in g.items():
                    for n, t in lg.items():
                        acc[k][n].add_(t.to(dev))
        self._cross(_leaves(acc))
        grads = _map(self._div, acc)
        return grads, self._pmean_state(states), self._loss_mean(losses)

    def _step_dense(self, it, ds, rng):
        model = self.model
        grads, state, loss = self._reduced_grads(ds, rng)
        dv = model._update(it, model._normalize_gradients(
            self._by_id(grads)), state, loss, None)
        self._push_params()
        return loss, dv, None

    def _rs_upd_trees(self):
        return list(self._rs_state) + [self.model.updater_state]

    def _step_dense_rs(self, it, ds, rng):
        """dense_rs: the dense reduction, then each replica's shard
        update (`_rs_update`), the shards written back into the params
        (the all-gather, across processes too)."""
        model = self.model
        grads, state, loss = self._reduced_grads(ds, rng)
        by_id = model._normalize_gradients(self._by_id(grads))
        ctx = self._diag_begin(self._rs_upd_trees())
        with torch.no_grad():
            self._rs_update(it, by_id)
            model._apply_constraints()
        dv, state = self._diag_end(ctx, loss, state, residual=False)
        model.params_changed()
        model._commit_state(state)
        self._push_params()
        return loss, dv, None

    @torch.no_grad()
    def _rs_update(self, it, by_id):
        """The container's update groups (`_apply_updates`: fused Adam
        over a packed run, per leaf otherwise) run replica by replica on
        each sharded leaf's last-axis block with that replica's state
        shard, and once on every replicated leaf with the full state;
        then the blocks other processes updated are gathered in."""
        model, n, plan = self.model, self.n_workers, self._rs_plan()
        cd = model.dtype.compute_dtype
        for group in model._update_groups():
            updater = model.updater_of(model.layers[group[0]])
            fused = type(updater) is Adam and len(group) > 1
            for j, r in enumerate(self._rid):
                ps, gs_, states, back = [], [], [], []
                for i in group:
                    key = model.layer_keys[i]
                    for name, p in model.layers[i].jax_param_map().items():
                        g = by_id.get(id(p))
                        if g is None:
                            g = torch.zeros_like(p, dtype=cd)
                        if plan[key][name]:
                            sl = coll.shard_slice(n, r, p.shape[-1])
                            tmp = p[..., sl].contiguous()
                            ps.append(tmp)
                            gs_.append(g[..., sl].contiguous())
                            states.append(self._rs_state[j][key][name])
                            back.append((p, sl, tmp))
                        elif j == 0:
                            ps.append(p)
                            gs_.append(g)
                            states.append(model.updater_state[key][name])
                if not ps:
                    continue
                if fused:
                    adam_update_packed(updater, ps, gs_,
                                       [s["m"] for s in states],
                                       [s["v"] for s in states], it)
                else:
                    for p, g, st in zip(ps, gs_, states):
                        upd, new = updater.apply(g.to(p.dtype), st, it)
                        p.sub_(upd.to(p.dtype))
                        st.update(new)
                for p, sl, tmp in back:
                    p[..., sl].copy_(tmp)
        self._gather_rs_params()

    def _local_blocks(self):
        """This process's replicas as (first, stop) global indices."""
        L = len(self._rid)
        if self._xp is not None and L * self._xp.size != self.n_workers:
            raise NotImplementedError(
                "the rs modes across processes need the same replica count "
                "in every process")
        return self._rid[0], self._rid[0] + L

    @torch.no_grad()
    def _gather_rs_params(self):
        """Across processes, the all-gather of the rs shards: every
        sharded leaf's blocks, this process's replicas' from here and
        the others' from their processes."""
        if self._xp is None:
            return
        plan = self._rs_plan()
        leaves = [p for lk, lp in self._params().items()
                  for pn, p in lp.items() if plan[lk][pn]]
        self._gather_last_axis(leaves)

    def _gather_last_axis(self, leaves):
        """Fill each leaf's blocks of the other processes (its last axis
        split n ways, this process holding `_local_blocks`) from theirs,
        one all-gather a dtype."""
        n = self.n_workers
        lo, hi = self._local_blocks()
        L = hi - lo
        by_dtype = {}
        for p in leaves:
            by_dtype.setdefault(p.dtype, []).append(p)
        for ps in by_dtype.values():
            mine = torch.cat([p[..., lo * (p.shape[-1] // n):
                                hi * (p.shape[-1] // n)].reshape(-1)
                              for p in ps])
            outs = self._xp.all_gather(mine)
            for q, flat in enumerate(outs):
                if q == self._xp.index:
                    continue
                off = 0
                for p in ps:
                    s = p.shape[-1] // n
                    blk = p[..., q * L * s:(q + 1) * L * s]
                    k = blk.numel()
                    blk.copy_(flat[off:off + k].view(blk.shape))
                    off += k

    def _shard_rs_state(self):
        """Replica r's state shard of every sharded leaf (its last-axis
        block, its own tensor), for this process's replicas; replicated
        leaves keep the model's state."""
        plan, n = self._rs_plan(), self.n_workers
        out = []
        for r, d in zip(self._rid, self.devices):
            tree = {}
            for lk, lst in self.model.updater_state.items():
                tree[lk] = {}
                for pk, slots in lst.items():
                    if plan[lk][pk]:
                        tree[lk][pk] = {
                            s: t[..., coll.shard_slice(n, r, t.shape[-1])]
                            .to(d, copy=True).contiguous()
                            for s, t in slots.items()}
            out.append(tree)
        self._rs_state = out

    @torch.no_grad()
    def _rs_full_state(self):
        """The full per-layer updater tree (the checkpoint and model view
        of sharded state): shards concatenated along the last axis
        (across processes too), replicated leaves as they are."""
        plan, dev, n = self._rs_plan(), self.model.device, self.n_workers
        lo, hi = self._local_blocks()
        full, whole = {}, []
        for lk, lst in self.model.updater_state.items():
            full[lk] = {}
            for pk, slots in lst.items():
                if not plan[lk][pk]:
                    full[lk][pk] = dict(slots)
                    continue
                full[lk][pk] = {}
                for s, t in slots.items():
                    w = t.shape[-1] // n
                    out = torch.zeros(t.shape, dtype=t.dtype, device=dev)
                    out[..., lo * w:hi * w].copy_(coll.all_gather(
                        [self._rs_state[j][lk][pk][s]
                         for j in range(len(self._rid))], dev))
                    full[lk][pk][s] = out
                    whole.append(out)
        if self._xp is not None:
            self._gather_last_axis(whole)
        return full

    def _buckets(self, per_bucket: bool):
        if per_bucket:
            return gs.bucket_plan(self.model)
        return [("", list(self._params()))]

    def _step_threshold(self, it, ds, rng, per_bucket):
        """threshold: each replica's gradients, gradient normalization and
        own updater give its update; the update plus its residual is
        encoded per bucket, the wire tensors summed (across processes
        too), the shared update decoded and applied; τ adapts per
        bucket."""
        model, cfg = self.model, self.threshold_config
        c = model.conf
        dev = model.device
        nets = self._nets()
        params = self._params()
        layers = dict(model.keyed())
        ctx = self._diag_begin(self._upd_r)
        losses, states, deltas = [], [], []
        for j, (r, x, y) in enumerate(self._replica_batches(ds)):
            loss, g, st = self._replica_pass(nets[j], x, y,
                                             prng.fold_in(rng, r))
            losses.append(loss)
            states.append(st)
            g = apply_gradient_normalization(
                g, c.gradient_normalization, c.gradient_normalization_threshold)
            u = self._upd_r[j]
            d = {}
            for lk, lg in g.items():
                updater = model.updater_of(layers[lk])
                d[lk] = {}
                for pk, gg in lg.items():
                    pd = params[lk][pk].dtype
                    delta, new = updater.apply(gg.to(pd), u[lk][pk], it)
                    u[lk][pk].update(new)
                    d[lk][pk] = delta.to(pd)
            deltas.append(d)
        sp_weighted = torch.zeros((), dtype=torch.float32, device=dev)
        with torch.no_grad():
            for bkey, members in self._buckets(per_bucket):
                tau = (self._tau[members[0]] if per_bucket else self._tau)
                dhat, _, new_tau, sp = gs.threshold_exchange(
                    [{lk: d[lk] for lk in members} for d in deltas],
                    [{lk: res[lk] for lk in members} for res in self._res_r],
                    tau, cfg, device=dev, xp=self._xp,
                    n_total=self.n_workers)
                for lk, ld in dhat.items():
                    for pk, v in ld.items():
                        params[lk][pk].sub_(v)
                if per_bucket:
                    for lk in members:
                        self._tau[lk] = new_tau
                else:
                    self._tau = new_tau
                sp_weighted = sp_weighted + sp * gs.tree_elements(
                    {lk: params[lk] for lk in members})
            model._apply_constraints()
        loss = self._loss_mean(losses)
        dv, state = self._diag_end(ctx, loss, self._pmean_state(states))
        model.params_changed()
        model._commit_state(state)
        self._push_params()
        sparsity = sp_weighted / torch.tensor(
            gs.tree_elements(params), dtype=torch.float32, device=dev)
        return loss, dv, sparsity

    def _step_threshold_rs(self, it, ds, rng):
        """threshold_rs: each replica's RAW gradient plus residual encoded
        per bucket; the integer sum reduce-scattered; the decoded
        gradient shard (elementwise gradient normalization) through the
        updater with that replica's state shard; updated shards
        gathered. Replicated leaves update once with the full state."""
        model, cfg, n = self.model, self.threshold_config, self.n_workers
        c = model.conf
        dev = model.device
        plan = self._rs_plan()
        wdtype = gs.wire_dtype(n)
        nets = self._nets()
        params = self._params()
        layers = dict(model.keyed())
        buckets = self._buckets(True)
        ctx = self._diag_begin(self._rs_upd_trees())
        summed = {lk: {pk: None for pk in lp} for lk, lp in params.items()}
        sent = {b: [] for b, _ in buckets}
        losses, states = [], []
        for j, (r, x, y) in enumerate(self._replica_batches(ds)):
            loss, g, st = self._replica_pass(nets[j], x, y,
                                             prng.fold_in(rng, r))
            losses.append(loss)
            states.append(st)
            res = self._res_r[j]
            for bkey, members in buckets:
                tau = self._tau[members[0]]
                s_b = torch.zeros((), dtype=torch.float32, device=dev)
                for lk in members:
                    for pk, gg in g[lk].items():
                        gg = gg.to(res[lk][pk].dtype)
                        enc, new_res, s = gs.encode_leaf(
                            gg + res[lk][pk], tau, wdtype)
                        res[lk][pk] = new_res.to(res[lk][pk].dtype)
                        e = enc.to(dev, torch.int32)
                        prev = summed[lk][pk]
                        summed[lk][pk] = e if prev is None else prev.add_(e)
                        s_b = s_b + s.to(dev)
                sent[bkey].append(s_b)
        sent = {b: coll.reduce_sum(v, dev) for b, v in sent.items()}
        self._cross(_leaves(summed) + list(sent.values()))
        gn, gn_t = c.gradient_normalization, c.gradient_normalization_threshold
        with torch.no_grad():
            for bkey, members in buckets:
                tau = self._tau[members[0]]
                for lk in members:
                    updater = model.updater_of(layers[lk])
                    for pk, p in params[lk].items():
                        scale = gs.decode_scale(tau, n, torch.float32)
                        wire = summed[lk][pk]
                        if plan[lk][pk]:
                            for j, r in enumerate(self._rid):
                                sl = coll.shard_slice(n, r, p.shape[-1])
                                gsh = gs.elementwise_gn(
                                    wire[..., sl].to(torch.float32) * scale,
                                    gn, gn_t)
                                st = self._rs_state[j][lk][pk]
                                d, su = updater.apply(gsh, st, it)
                                st.update(su)
                                p[..., sl].copy_(p[..., sl] - d.to(p.dtype))
                        else:
                            ghat = gs.elementwise_gn(
                                wire.to(torch.float32) * scale, gn, gn_t)
                            st = model.updater_state[lk][pk]
                            d, su = updater.apply(ghat, st, it)
                            st.update(su)
                            p.sub_(d.to(p.dtype))
                elems = gs.tree_elements({lk: params[lk] for lk in members})
                sp = self._div(sent[bkey]) / torch.tensor(
                    elems, dtype=torch.float32, device=dev)
                new_tau = gs.adapt_threshold(tau, sp, cfg)
                for lk in members:
                    self._tau[lk] = new_tau
                sent[bkey] = sp * elems
            self._gather_rs_params()
            model._apply_constraints()
        loss = self._loss_mean(losses)
        dv, state = self._diag_end(ctx, loss, self._pmean_state(states))
        model.params_changed()
        model._commit_state(state)
        self._push_params()
        sparsity = sum(sent.values()) / torch.tensor(
            gs.tree_elements(params), dtype=torch.float32, device=dev)
        return loss, dv, sparsity

    # --------------------------------------------------- threshold state
    def _threshold_state(self, per_bucket: bool):
        """The residual stack and τ, created on first use and kept across
        fits (and checkpoints) like updater state; τ is coerced to the
        form the step needs."""
        params = self._params()
        if self._resume_res is not None:
            stack, self._resume_res = self._resume_res, None
            self._res_r = [_unstack(stack, r, d)
                           for r, d in zip(self._rid, self.devices)]
        if self._res_r is None:
            self._res_r = [gs.zeros_residual(params, d)
                           for d in self.devices]
        tau = gs.ensure_tau_form(self._thr_tau, per_bucket, params,
                                 self.threshold_config)
        dev = self.model.device

        def t(v):
            return (v if isinstance(v, torch.Tensor) else torch.tensor(
                np.float32(v), dtype=torch.float32)).to(dev)
        self._tau = ({k: t(v) for k, v in tau.items()}
                     if isinstance(tau, dict) else t(tau))

    def threshold_residual(self):
        """Host view of the per-replica residual ({layer: {name: [N,
        ...]}}, every replica's, across processes too), or None before
        the first threshold step."""
        if self._res_r is None:
            return None
        return self._full_stack(self._res_r)

    def _place_upd_r(self):
        """threshold: this process's first replica's updater state IS
        the model's; the others start as copies of it (JAX replicates
        the model's view at every fit) or from a resumed stack."""
        model = self.model
        if self._resume_upd_r is not None:
            stack, self._resume_upd_r = self._resume_upd_r, None
            _copy_into(model.updater_state, _unstack(stack, self._rid[0],
                                                     model.device))
            rest = [_unstack(stack, r, d)
                    for r, d in zip(self._rid[1:], self.devices[1:])]
        else:
            rest = [_map(lambda t, d=d: t.to(d, copy=True),
                         model.updater_state)
                    for d in self.devices[1:]]
        self._upd_r = [model.updater_state] + rest

    # -------------------------------------------------------- averaging
    def _avg_step(self, it, ds, rng):
        nets = self._nets()
        losses = []
        for j, (r, x, y) in enumerate(self._replica_batches(ds)):
            net = nets[j]
            loss, grads, st = net._loss_and_grads(
                lambda s, net=net, x=x, y=y, r=r: net._loss_fn(
                    x, y, train=True, rng=prng.fold_in(rng, r),
                    new_state=s))
            net._update(it, net._normalize_gradients(grads), st, loss, None)
            losses.append(loss)
        return losses

    def _avg_score(self, losses) -> float:
        """Averaging's reported score: the mean of every replica's local
        loss (across processes too)."""
        if self._xp is None:
            return float(torch.stack([l.float().cpu()
                                      for l in losses]).mean())
        return float(self._loss_mean(losses))

    @torch.no_grad()
    def _average(self):
        """Every replica's params and running state (and updater state
        when `average_updater_state`) replaced by the replica mean (this
        process's replicas summed in replica order, then across
        processes)."""
        nets = self._nets()
        dev = self.model.device
        whats = ["params", "net_state"] + (
            ["updater_state"] if self.average_updater_state else [])
        groups = []
        for what in whats:
            trees = [self._tree_of(n, what) for n in nets]

            def walk(ts):
                if isinstance(ts[0], dict):
                    for k in ts[0]:
                        walk([t[k] for t in ts])
                elif ts[0].is_floating_point():
                    groups.append(ts)
            walk(trees)
        sums = self._cross([coll.reduce_sum(ts, dev) for ts in groups])
        for ts, m in zip(groups, sums):
            self._div(m)
            for t in ts:
                t.copy_(m.to(t.device))
        for n in nets:
            n.params_changed()

    def _load_replicas(self, stacks=None):
        """Averaging: every replica but the model from the model's trees
        (a cold start) or from resumed stacks."""
        nets = self._nets()
        for r, net in zip(self._rid, nets):
            for what in ("params", "net_state", "updater_state"):
                if stacks is not None and stacks.get(what):
                    _copy_into(self._tree_of(net, what),
                               _unstack(stacks[what], r, net.device))
                elif net is not self.model:
                    _copy_into(self._tree_of(net, what),
                               self._tree_of(self.model, what))
            net.params_changed()

    # ---------------------------------------------------------- resume
    def _restore_fault_state(self, arrays, meta):
        """`fault.resume` hook: the residual and τ, the per-replica
        updater stack, or averaging's stacks and cadence, re-sharded when
        the checkpoint's replica count differs (elastic resume)."""
        if not arrays and not meta:
            return
        from deeplearning4j_tpu_torch.fault import state as fs
        kind = meta.get("kind")
        n = self.n_workers
        if kind in ("threshold", "threshold_rs"):
            res_r = arrays.get("residual_r")
            if res_r:
                self._resume_res = fs.reshard_replica_stack(
                    res_r, n, kind="residual")
                self._res_r = None
            tau = arrays.get("tau")
            if tau is not None:
                self._thr_tau = gs.restore_tau(tau)
            upd_r = arrays.get("upd_r")
            if upd_r:
                self._resume_upd_r = fs.reshard_replica_stack(
                    upd_r, n, kind="state")
        elif kind == "averaging":
            stacks = {}
            for k, what in (("params_r", "params"), ("upd_r",
                                                    "updater_state"),
                            ("state_r", "net_state")):
                t = arrays.get(k)
                stacks[what] = (fs.reshard_replica_stack(t, n, kind="state")
                                if t else {})
            stacks["since_avg"] = int(meta.get("since_avg", 0))
            self._resume_avg = stacks

    def resume(self, directory, *, iterator=None):
        """Restore the model and this trainer's state from the newest
        valid checkpoint under `directory` (params, running state, the
        per-replica stacks, residual and τ or averaging's cadence, the
        counters, the iterator's cursor); a following `fit()` continues
        the interrupted run. Returns the model."""
        from deeplearning4j_tpu_torch import fault
        model, _ = fault.resume(directory, model=self.model, trainer=self,
                                iterator=iterator)
        return model

    # ---------------------------------------------------------- evaluate
    def evaluate(self, data, labels=None, *, batch_size: int = 32,
                 evaluation=None):
        """Mesh-wide evaluation: each batch's rows split over the
        replicas' forwards (a ragged tail zero-padded to the axis
        multiple, the padding sliced off), into one Evaluation."""
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
        _require_single_process()
        iterator = as_iterator(data, labels, batch_size=batch_size)
        if hasattr(iterator, "reset"):
            iterator.reset()
        self._push_params()
        nets = self._nets() if self.mode != "averaging" else [
            self.model] * self.n_workers
        n = self.n_workers

        def forward(x):
            b = x.shape[0] // n
            outs = []
            for r in range(n):
                net = nets[r]
                xr = x[r * b:(r + 1) * b]
                with torch.no_grad():
                    outs.append(net._eval_output(xr, None).float().cpu())
            return torch.cat(outs).numpy()

        merged = evaluation if evaluation is not None else Evaluation()
        return _mesh_evaluate(iterator, merged, n, forward)

    # ------------------------------------------------------------- loop
    @staticmethod
    def _run_grouped(iterator, epochs, spe, divisible, run_single, drain,
                     model, listeners=None):
        """JAX's epoch and grouping loop: up to `spe` same-shape batches
        drain as one group; partial groups (epoch tails, shape changes)
        run per step. Epoch and fit events fire as the containers'
        fits fire them."""
        def flush(pending):
            if len(pending) == spe:
                drain(pending)
            else:
                for d in pending:
                    run_single(d)

        if listeners is not None:
            listeners.on_fit_start(model)
        for _ in range(epochs):
            if listeners is not None:
                listeners.on_epoch_start(model, model.epoch_count)
            if hasattr(iterator, "reset"):
                iterator.reset()
            pending = []
            for ds in iterator:
                if not divisible(ds):
                    continue
                if spe == 1:
                    run_single(ds)
                    continue
                if pending and np.shape(ds.features) != np.shape(
                        pending[0].features):
                    flush(pending)
                    pending = []
                pending.append(ds)
                if len(pending) >= spe:
                    drain(pending)
                    pending = []
            flush(pending)
            if listeners is not None:
                listeners.on_epoch_end(model, model.epoch_count)
            model.epoch_count += 1
        if listeners is not None:
            listeners.on_fit_end(model)

    def _sync_mode(self):
        """The exchange `fit` runs: "global" (single barrier dense), or
        one of the gradient-sharing modes (bucketed where it applies)."""
        gsmode = self.gradient_sharing
        if (gsmode == "dense" and self.bucketed
                and not self._updater_state_floats()):
            return "global"
        if self._multi_io_graph:
            if gsmode == "dense":
                return "global"
            raise NotImplementedError(
                f"gradient_sharing={gsmode!r} supports single-"
                "input single-output models; train multi-io "
                "graphs with gradient_sharing='dense' or via "
                "model.fit")
        if gsmode in gs.RS_MODES:
            if not self._updater_state_floats():
                raise ValueError(
                    f"gradient_sharing={gsmode!r} threads updater state "
                    "through the bucketed exchange and requires float "
                    "state leaves, but this model's updater has non-float "
                    "state; use gradient_sharing='dense' or 'threshold' "
                    "with bucketed=False instead")
            return gsmode
        if gsmode == "dense":
            return "dense" if self.bucketed else "global"
        return "threshold" if self.bucketed else "threshold_single"

    def fit(self, data, labels=None, *, epochs: int = 1, batch_size: int = 32,
            steps_per_execution: int = 1):
        """Global-batch training over the mesh; `batch_size` is the
        GLOBAL batch and must divide by the data axis (a ragged batch is
        dropped with a warning; if every batch is, `fit` raises).
        `steps_per_execution` k > 1 runs groups of k same-shape batches
        back to back and reads their losses once (numbers equal to
        per-step; stats force per-step in averaging mode)."""
        model = self.model
        iterator = as_iterator(data, labels, batch_size=batch_size)
        bind = getattr(iterator, "bind_model", None)
        if bind is not None:
            bind(model)
        monitor.attach_master_stats(self.stats)
        listeners = ComposedListeners(model.listeners
                                      + monitor.extra_listeners())
        rng_root = prng.key(model.conf.seed + self._rng_offset)
        n_div = self.n_workers
        batch_stats = {"trained": 0, "dropped": 0}

        def divisible(ds):
            n = ds.num_examples()
            if n % n_div == 0:
                batch_stats["trained"] += 1
                return True
            batch_stats["dropped"] += 1
            if not getattr(self, "_warned_ragged", False):
                log.warning(
                    "dropping ragged batch of %d examples (not divisible "
                    "by %d-way data parallelism); pad the dataset or pick "
                    "a divisible batch_size to train on every example",
                    n, n_div)
                self._warned_ragged = True
            return False

        def check_trained():
            if batch_stats["dropped"] and not batch_stats["trained"]:
                raise ValueError(
                    f"every batch was indivisible by the {n_div}-way data "
                    f"axis — fit() would be a silent no-op; use a "
                    f"batch_size divisible by {n_div}")

        if self.mode == "averaging":
            return self._fit_averaging(iterator, listeners, rng_root, epochs,
                                       steps_per_execution, divisible,
                                       check_trained)
        return self._fit_sync(self._sync_mode(), iterator, listeners,
                              rng_root, epochs, steps_per_execution,
                              divisible, check_trained)

    def _fit_sync(self, smode, iterator, listeners, rng_root, epochs,
                  steps_per_execution, divisible, check_trained):
        model = self.model
        mode = {"global": "dense", "threshold_single": "threshold"}.get(
            smode, smode)
        has_thr = mode in ("threshold", "threshold_rs")
        rs = mode in gs.RS_MODES
        diag_name = "fit" if smode in ("global", "dense") else "exchange"

        def place():
            self._push_params()
            if smode in ("threshold", "threshold_single"):
                self._place_upd_r()
            if rs:
                self._shard_rs_state()
            if has_thr:
                self._threshold_state(per_bucket=smode != "threshold_single")

        if self.stats is not None:
            with self.stats.time_phase("broadcast"):
                place()
                self._sync()
        else:
            place()
        step = {"global": self._step_global, "dense": self._step_dense,
                "dense_rs": self._step_dense_rs,
                "threshold_rs": self._step_threshold_rs,
                "threshold": lambda it, ds, rng: self._step_threshold(
                    it, ds, rng, True),
                "threshold_single": lambda it, ds, rng:
                    self._step_threshold(it, ds, rng, False)}[smode]
        spe = max(1, int(steps_per_execution))
        eager_loss = bool(model.listeners) or self.stats is not None
        rs_plan = self._rs_plan() if rs else None
        params = self._params()
        wire_b = gs.exchange_wire_bytes(
            params, mode, n_workers=self.n_workers, rs_plan=rs_plan,
            grad_dtype=model.dtype.compute_dtype)
        dense_b = gs.exchange_wire_bytes(
            params, "dense", grad_dtype=model.dtype.compute_dtype)
        last = {"loss": None, "sp": None}
        meta = {"kind": _KIND[mode], "trainer": self._trainer_name,
                "n_workers": self.n_workers}
        if smode in ("dense", "threshold", "dense_rs", "threshold_rs"):
            meta["bucketed"] = True

        def updater_view():
            return self._rs_full_state() if rs else model.updater_state

        def live_state():
            src = {"params": self._params(), "net_state": model.net_state,
                   "updater_state": updater_view(),
                   "trainer_meta": dict(meta)}
            if has_thr:
                arrays = {"residual_r": self._full_stack(self._res_r),
                          "tau": self._tau}
                if mode == "threshold":
                    arrays["upd_r"] = self._full_stack(self._upd_r)
                src["trainer_arrays"] = arrays
            return src

        def tau_now():
            return gs.tau_scalar(self._tau)

        def one(ds, it):
            return step(it, ds, prng.fold_in(rng_root, it))

        def run_single(ds):
            it = model.iteration_count
            t0 = time.perf_counter()
            loss, dv, sp = one(ds, it)
            last["loss"], last["sp"] = loss, sp
            gs.record_exchange(mode, wire_b, dense_b, 1, trainer=self._trainer_name)
            if eager_loss:
                model.score_value = float(loss)
                if has_thr:
                    gs.record_threshold_stats(tau_now(), float(sp),
                                              trainer=self._trainer_name)
            rows = process_if_due(model, dv, diag_name, it)
            if self.stats is not None:
                self._sync()
                self.stats.record("sync_step", time.perf_counter() - t0,
                                  iteration=it)
                self.stats.next_round()
            listeners.iteration_done(
                model, it, model.epoch_count,
                model.score_value if eager_loss else float("nan"),
                batch_size=ds.num_examples(),
                diagnostics=rows[-1] if rows else None)
            model.iteration_count += 1

        def drain(pending):
            if len(pending) == 1:
                run_single(pending[0])
                return
            it0 = model.iteration_count
            t0 = time.perf_counter()
            losses, dvs, sps = [], [], []
            for j, ds in enumerate(pending):
                loss, dv, sp = one(ds, it0 + j)
                losses.append(loss.float())
                dvs.append(dv)
                sps.append(sp)
            last["loss"], last["sp"] = losses[-1], sps[-1]
            gs.record_exchange(mode, wire_b, dense_b, len(pending),
                               trainer=self._trainer_name)
            lv = torch.stack(losses).cpu().numpy() if eager_loss else None
            if eager_loss and has_thr:
                gs.record_threshold_stats(tau_now(), float(sps[-1]),
                                          trainer=self._trainer_name)
            rows = (process_if_due(model, dvs, diag_name, it0, len(pending))
                    if any(d is not None for d in dvs) else None)
            if self.stats is not None:
                self._sync()
                self.stats.record("sync_step", time.perf_counter() - t0,
                                  iteration=it0, fused_steps=len(pending))
                self.stats.next_round()
            for j, d in enumerate(pending):
                if eager_loss:
                    model.score_value = float(lv[j])
                listeners.iteration_done(
                    model, model.iteration_count, model.epoch_count,
                    model.score_value if eager_loss else float("nan"),
                    batch_size=d.num_examples(),
                    step_boundary=j == len(pending) - 1,
                    diagnostics=(rows[j] if rows
                                 and model._diag.due(model.iteration_count)
                                 else None))
                model.iteration_count += 1

        model._live_state_provider = live_state
        try:
            self._run_grouped(iterator, epochs, spe, divisible, run_single,
                              drain, model, listeners)
        finally:
            model._live_state_provider = None
        check_trained()
        if last["loss"] is not None and not eager_loss:
            model.score_value = float(last["loss"])
        if has_thr and last["sp"] is not None:
            gs.record_threshold_stats(tau_now(), float(last["sp"]),
                                      trainer=self._trainer_name)
        if has_thr:
            self._thr_tau = self._tau
        if rs:
            _copy_into(model.updater_state, self._rs_full_state())
        return model

    def _fit_averaging(self, iterator, listeners, rng_root, epochs,
                       steps_per_execution, divisible, check_trained):
        model = self.model
        spe = max(1, int(steps_per_execution))
        if self.stats is not None:
            spe = 1
        cadence = {"since": 0}

        def place():
            if self._resume_avg is not None:
                ra, self._resume_avg = self._resume_avg, None
                self._load_replicas(ra)
                cadence["since"] = ra["since_avg"]
            else:
                self._load_replicas()

        if self.stats is not None:
            with self.stats.time_phase("broadcast"):
                place()
                self._sync()
        else:
            place()
        eager_loss = bool(model.listeners) or self.stats is not None
        last = {"losses": None}

        def live_state():
            nets = self._nets()
            r0 = nets[0]
            return {"params": self._tree_of(r0, "params"),
                    "net_state": r0.net_state,
                    "updater_state": r0.updater_state,
                    "trainer_arrays": {
                        "params_r": self._full_stack(
                            [self._tree_of(n, "params") for n in nets]),
                        "upd_r": self._full_stack(
                            [n.updater_state for n in nets]),
                        "state_r": self._full_stack(
                            [n.net_state for n in nets])},
                    "trainer_meta": {"kind": "averaging",
                                     "trainer": self._trainer_name,
                                     "since_avg": int(cadence["since"]),
                                     "n_workers": self.n_workers}}

        def local(ds, it):
            t0 = time.perf_counter()
            losses = self._avg_step(it, ds, prng.fold_in(rng_root, it))
            if self.stats is not None:
                self._sync()
                self.stats.record("local_fit", time.perf_counter() - t0,
                                  iteration=it)
            cadence["since"] += 1
            if cadence["since"] >= self.averaging_frequency:
                t0 = time.perf_counter()
                self._average()
                if self.stats is not None:
                    self._sync()
                    self.stats.record("average", time.perf_counter() - t0,
                                      round=self.stats.next_round())
                cadence["since"] = 0
            return losses

        def run_single(ds):
            it = model.iteration_count
            losses = local(ds, it)
            last["losses"] = losses
            if eager_loss:
                model.score_value = self._avg_score(losses)
            listeners.iteration_done(
                model, it, model.epoch_count,
                model.score_value if eager_loss else float("nan"),
                batch_size=ds.num_examples())
            model.iteration_count += 1

        def drain(pending):
            if len(pending) == 1:
                run_single(pending[0])
                return
            it0 = model.iteration_count
            all_losses = []
            for j, ds in enumerate(pending):
                losses = local(ds, it0 + j)
                all_losses.append(losses)
            last["losses"] = losses
            for j, d in enumerate(pending):
                if eager_loss:
                    model.score_value = self._avg_score(all_losses[j])
                listeners.iteration_done(
                    model, model.iteration_count, model.epoch_count,
                    model.score_value if eager_loss else float("nan"),
                    batch_size=d.num_examples(),
                    step_boundary=j == len(pending) - 1)
                model.iteration_count += 1

        model._live_state_provider = live_state
        try:
            self._run_grouped(iterator, epochs, spe, divisible, run_single,
                              drain, model, listeners)
        finally:
            model._live_state_provider = None
        if cadence["since"]:
            self._average()
            cadence["since"] = 0
        if last["losses"] is not None and not eager_loss:
            model.score_value = self._avg_score(last["losses"])
        check_trained()
        nets = self._nets()
        if nets[0] is not model:
            for what in ("params", "net_state", "updater_state"):
                _copy_into(self._tree_of(model, what),
                           self._tree_of(nets[0], what))
            model.params_changed()
        return model
