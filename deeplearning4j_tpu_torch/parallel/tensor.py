"""Tensor, FSDP and expert sharding: param spec functions and the
sharded trainer (counterpart of `deeplearning4j_tpu/parallel/tensor.py`).

A spec is a tuple with one entry per dimension of a param, each a mesh
axis name or None; ``()`` means replicated (JAX's `PartitionSpec`).
`tp_param_specs`, `fsdp_param_specs` and `moe_param_specs` are pure
functions of the model's params and give JAX's specs entry for entry:
the last axis sharded (the output features of a Dense "W" [in, out] and
of an HWIO conv kernel), 1-D params on their only axis, nothing that the
axis size does not divide, FSDP's small params replicated, the final
output layer replicated, and MoE experts on their leading axis.

`ShardedParallelTrainer` keeps JAX's contract that a sharding is an
annotation that never changes the math, as ZeRO-3:

- at the start of a `fit` each sharded param and each of its updater
  slots moves into contiguous shards along its spec's axis, shard j on
  the mesh device at index j of that axis (this process's shards only,
  when a mesh spans processes), and the model's full copies are
  released: between steps a process holds its shards and the
  replicated leaves, and nothing else;
- a dense step gathers the full params onto the model's device (the
  step's compute copy), runs the container's own forward and backward
  on the global batch there (across processes, each its rows of it
  under `common.global_batch`, the gradients summed across processes),
  which keeps JAX's global program: the global key
  ``fold_in(PRNGKey(seed + 5), it)`` and BatchNorm over the global
  batch;
- the full-tensor parts of the update (gradient normalization) run
  first; then every owner updates its shards with the container's
  update groups (fused Adam over a packed run's shards in one launch);
  the shards are gathered into the compute copy, the constraints and
  the diagnostics' ``skip`` gate act on the full tensors and are
  written back into the shards, and the compute copy is released after
  the step's listeners;
- at the end of the `fit` the model is whole again: its full params and
  slots gathered from the shards.

The threshold exchange runs per data replica as `ParallelTrainer`'s
does (each replica its own updater state and residual), over the data
axis's devices, under this trainer's key. Splitting the layers' matmuls
over the model axis (Megatron-style activation sharding) is not done:
the compute copy holds the full params and the full activations.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.common import prng
from deeplearning4j_tpu_torch.common.updaters import Adam
from deeplearning4j_tpu_torch.datasets.iterator import as_iterator
from deeplearning4j_tpu_torch.kernels.fused_adam import adam_update_packed
from deeplearning4j_tpu_torch.monitor.diagnostics import (
    keep_finite_,
    process_if_due,
    snapshot,
)
from deeplearning4j_tpu_torch.optimize.listeners import ComposedListeners
from deeplearning4j_tpu_torch.parallel import collectives as coll


def _params_of(model) -> Dict[str, Dict[str, torch.Tensor]]:
    return {k: layer.jax_param_map() for k, layer in model.keyed()
            if layer.jax_param_map()}


def _is_graph(model) -> bool:
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    return isinstance(model, ComputationGraph)


def tp_param_specs(model, model_axis: str = "model",
                   shard_output_layer: bool = False,
                   axis_size: Optional[int] = None) -> Dict:
    """Spec tree matching the model's params for both containers
    (MultiLayerNetwork keys by layer index, ComputationGraph by node
    name): every >=2-D param shards its LAST axis over `model_axis`,
    1-D params their only axis, the final output layer stays
    replicated, and an axis `axis_size` does not divide stays
    replicated."""
    if _is_graph(model):
        outputs = set(model.conf.network_outputs)

        def is_output(lk):
            return lk in outputs
    else:
        n_layers = len(model.layers)

        def is_output(lk):
            return int(lk) == n_layers - 1

    def replicate(lk, pn, arr):
        return is_output(lk) and not shard_output_layer

    return _last_axis_specs(model, model_axis, axis_size, replicate,
                            shard_1d=True)


def _last_axis_specs(model, axis, axis_size, replicate_pred, *, shard_1d):
    def divides(dim):
        return axis_size is None or (dim % axis_size == 0)

    specs: Dict[str, Dict] = {}
    for lk, lparams in _params_of(model).items():
        lspec = {}
        for pn, arr in lparams.items():
            nd = arr.ndim
            if (nd == 0 or replicate_pred(lk, pn, arr)
                    or not divides(arr.shape[-1])
                    or (nd == 1 and not shard_1d)):
                lspec[pn] = ()
            else:
                lspec[pn] = (None,) * (nd - 1) + (axis,)
        specs[lk] = lspec
    return specs


def fsdp_param_specs(model, data_axis: str = "data", *, axis_size: int,
                     min_shard_elems: int = 1024) -> Dict:
    """ZeRO-3 / FSDP: every param of at least `min_shard_elems` elements
    shards its LAST axis over the batch's own axis (when `axis_size`
    divides it); smaller params replicate."""
    def replicate(lk, pn, arr):
        return int(arr.numel()) < min_shard_elems

    return _last_axis_specs(model, data_axis, int(axis_size), replicate,
                            shard_1d=True)


def moe_param_specs(model, expert_axis: str = "expert",
                    model_axis: Optional[str] = None) -> Dict:
    """Expert parallelism: a MixtureOfExperts layer's expert params
    ("We*", "be*") shard their leading expert axis over `expert_axis`;
    other params replicate (or take `tp_param_specs` over `model_axis`
    when given)."""
    specs: Dict[str, Dict] = {}
    for lk, lparams in _params_of(model).items():
        layer = model.layers[int(lk)]
        is_moe = layer.layer_name == "mixture_of_experts"
        specs[lk] = {
            pn: ((expert_axis,) + (None,) * (arr.ndim - 1)
                 if is_moe and pn.startswith(("We", "be")) else ())
            for pn, arr in lparams.items()}
    if model_axis is not None:
        tp = tp_param_specs(model, model_axis)
        for lk in specs:
            for pn in specs[lk]:
                if specs[lk][pn] == ():
                    specs[lk][pn] = tp[lk][pn]
    return specs


def shard_dim(spec):
    """(dim, axis) of the one sharded dimension of `spec`, or None."""
    for d, a in enumerate(spec or ()):
        if a is not None:
            return d, a
    return None


class _Shards:
    """One sharded param's layout and this process's blocks of it: the
    param's (`p`) and each updater slot's (`state`), block j on
    `owners[j]`'s device (the mesh device at index j of the spec's axis
    on this process's line of it)."""

    def __init__(self, param, slots, dim, k, owners, mine):
        self.param, self.dim, self.k = param, dim, k
        self.owners = owners
        self.shape, self.dtype = tuple(param.shape), param.dtype
        self.slots = {s: (tuple(t.shape), t.dtype) for s, t in slots.items()}

        def block(t, j):
            return t.chunk(k, dim=dim)[j].to(owners[j][0],
                                              copy=True).contiguous()
        self.p = {j: block(param.detach(), j) for j in mine}
        self.state = {j: {s: block(t, j) for s, t in slots.items()}
                      for j in mine}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class ShardedParallelTrainer:
    """DP x TP (or FSDP, or expert) training: the batch over `data_axis`,
    params and updater state sharded by `param_specs` (default
    `tp_param_specs` over `model_axis`). `between_steps` records, after
    each dense step, the bytes of params and slots this process holds
    (`held_bytes`) and, on the card, `torch.cuda.memory_allocated` of
    its devices."""

    def __init__(self, model, mesh, *, data_axis: str = "data",
                 model_axis: str = "model",
                 param_specs: Optional[Dict] = None,
                 gradient_sharing: Optional[str] = None,
                 threshold_config=None, stats=None,
                 bucketed: Optional[bool] = None):
        from deeplearning4j_tpu_torch.parallel import gradient_sharing as gs
        self.model = model
        self.mesh = mesh
        self.stats = stats
        self.data_axis = data_axis
        self.model_axis = model_axis
        if param_specs is None:
            ax = (int(mesh.shape[model_axis])
                  if model_axis in mesh.shape else None)
            param_specs = tp_param_specs(model, model_axis, axis_size=ax)
        self.param_specs = param_specs
        self.gradient_sharing = gs.resolve_mode(gradient_sharing, model.conf)
        if self.gradient_sharing in gs.RS_MODES:
            if gs.env_mode() == self.gradient_sharing and (
                    gradient_sharing or "dense") not in gs.RS_MODES \
                    and getattr(model.conf, "gradient_sharing",
                                "dense") not in gs.RS_MODES:
                # the env's fleet-wide A/B toggle degrades to what the
                # argument or the configuration would have resolved
                for v in (gradient_sharing,
                          getattr(model.conf, "gradient_sharing", None)):
                    if v is not None:
                        self.gradient_sharing = v
                        break
                else:
                    self.gradient_sharing = "dense"
            else:
                raise NotImplementedError(
                    "dense_rs/threshold_rs shard the updater over the "
                    "data axis of a pure-DP mesh (ParallelTrainer); "
                    "under ShardedParallelTrainer the params are "
                    "GSPMD-sharded and FSDP-style sharding goes through "
                    "param_specs=fsdp_param_specs(...) instead")
        self.bucketed = gs.resolve_bucketed(bucketed)
        self.n_data = (int(mesh.shape[data_axis]) if data_axis in mesh.shape
                       else 1)
        if self.gradient_sharing == "threshold":
            gs.wire_dtype(self.n_data)
        self.threshold_config = (threshold_config if threshold_config
                                 is not None
                                 else gs.ThresholdConfig.from_conf(
                                     model.conf))
        self._is_graph = _is_graph(model)
        if self._is_graph and (len(model.conf.network_inputs) != 1
                               or len(model.conf.network_outputs) != 1):
            raise NotImplementedError(
                "ShardedParallelTrainer supports single-input single-"
                "output graphs; train multi-io graphs via "
                "ParallelTrainer or model.fit")
        self._thr = None            # the threshold exchange's trainer
        self._shards = None         # {(lk, pn): _Shards} during a fit
        self.between_steps: List[Dict] = []
        self._xp = self._world()

    # ------------------------------------------------------------ layout
    def _world(self):
        """The cross-process step over every process of the mesh (a
        dense step's gradient sum and the shards' gather), or None."""
        if self.mesh.ranks is None:
            return None
        return coll.cross_process(np.asarray(self.mesh.ranks).flat)

    def _axis_owners(self, axis):
        """For shard j of `axis`: (device, owning rank or None) along the
        mesh line of `axis` that holds this process's first entry (the
        line at index 0 of the other axes in one process)."""
        mesh = self.mesh
        if mesh.ranks is None:
            return list(zip(mesh.axis_devices(axis),
                            mesh.axis_ranks(axis)))
        from deeplearning4j_tpu_torch.parallel.multihost import (
            process_index)
        k = mesh.axis_names.index(axis)
        devs = np.moveaxis(mesh.devices, k, -1)
        ranks = np.moveaxis(mesh.ranks, k, -1)
        devs = devs.reshape(-1, devs.shape[-1])
        ranks = ranks.reshape(-1, ranks.shape[-1])
        me = process_index()
        line = next(i for i in range(ranks.shape[0]) if me in ranks[i])
        return [(devs[line, j], int(ranks[line, j]))
                for j in range(ranks.shape[1])]

    def _mine(self, axis) -> List[int]:
        """The shard indices of `axis` whose device this process
        drives."""
        from deeplearning4j_tpu_torch.parallel.multihost import (
            process_index)
        me = process_index()
        return [j for j, (_, rk) in enumerate(self._axis_owners(axis))
                if rk is None or rk == me]

    @torch.no_grad()
    def _place(self):
        """Move every sharded param and its updater slots into this
        process's shards: the model's full slots are dropped, and its
        full params stay as the first step's compute copy."""
        model = self.model
        self._shards = {}
        for lk, lp in _params_of(model).items():
            for pn, p in lp.items():
                sd = shard_dim(self.param_specs.get(lk, {}).get(pn, ()))
                if sd is None:
                    continue
                dim, axis = sd
                self._shards[(lk, pn)] = _Shards(
                    p, model.updater_state[lk][pn], dim,
                    int(self.mesh.shape[axis]), self._axis_owners(axis),
                    self._mine(axis))
                model.updater_state[lk][pn] = {}

    def _release(self):
        """Drop the compute copy of every sharded param: its shards are
        then its only copy."""
        for sh in self._shards.values():
            sh.param.data = sh.param.data.new_empty(0)

    @torch.no_grad()
    def _materialize(self):
        """The full params gathered from the shards into the compute
        copy (allocated on the model's device when released)."""
        items = []
        for sh in self._shards.values():
            if sh.param.numel() == 0:
                sh.param.data = torch.empty(sh.shape, dtype=sh.dtype,
                                            device=self.model.device)
            items.append((sh, sh.p, sh.param.data))
        self._gather_into(items)

    @torch.no_grad()
    def _scatter(self):
        """Every block of this process's shards from the compute copy
        (after the constraints and the ``skip`` gate wrote it)."""
        for sh in self._shards.values():
            parts = sh.param.data.chunk(sh.k, dim=sh.dim)
            for j, t in sh.p.items():
                t.copy_(parts[j])

    def _gather_into(self, items):
        """For each (shards, {j: block}, out): the full tensor written
        into `out`, this process's blocks copied and the other
        processes' taken from them, one all-gather a dtype (every
        process passes its blocks in the same order; each owns as many
        blocks of a tensor as the others)."""
        for sh, blocks, out in items:
            parts = out.chunk(sh.k, dim=sh.dim)
            for j, t in blocks.items():
                parts[j].copy_(t)
        xp = self._xp
        cross = [it for it in items if len(it[1]) < it[0].k]
        if xp is None or not cross:
            return
        by_dtype: Dict = {}
        for it in cross:
            by_dtype.setdefault(it[2].dtype, []).append(it)
        dev = self.model.device
        for group in by_dtype.values():
            flat = torch.cat([blocks[j].reshape(-1).to(dev)
                              for _, blocks, _ in group
                              for j in sorted(blocks)])
            for q, got in zip(xp.ranks, xp.all_gather(flat)):
                if q == xp.rank:
                    continue
                off = 0
                for sh, blocks, out in group:
                    parts = out.chunk(sh.k, dim=sh.dim)
                    n = parts[0].numel()
                    theirs = [j for j, (_, rk) in enumerate(sh.owners)
                              if rk == q]
                    for j in theirs:
                        parts[j].copy_(got[off:off + n].view(parts[j].shape))
                        off += n
                    if not theirs:      # q is on another line of the axis
                        off += n * len(blocks)

    def _full_state(self):
        """The model's updater tree with the sharded slots gathered from
        their shards (across processes too)."""
        model = self.model
        out = {lk: dict(lst) for lk, lst in model.updater_state.items()}
        items = []
        for (lk, pn), sh in self._shards.items():
            out[lk][pn] = {s: torch.empty(shape, dtype=dt,
                                          device=model.device)
                           for s, (shape, dt) in sh.slots.items()}
            items += [(sh, {j: st[s] for j, st in sh.state.items()},
                       out[lk][pn][s]) for s in sh.slots]
        self._gather_into(items)
        return out

    def _unplace(self):
        """The model whole again: its sharded params and updater slots
        gathered from the shards, which are dropped."""
        self._materialize()
        full = self._full_state()
        for lk, pn in self._shards:
            self.model.updater_state[lk][pn] = full[lk][pn]
        self._shards = None

    def held_bytes(self) -> int:
        """Bytes of params and updater slots this process holds now,
        counted from the live tensors: the model's (a released param
        holds none) and the shards'."""
        model = self.model
        n = sum(_nbytes(p) + sum(_nbytes(t) for t in
                                 model.updater_state[lk][pn].values())
                for lk, lp in _params_of(model).items()
                for pn, p in lp.items())
        for sh in (self._shards or {}).values():
            n += sum(_nbytes(t) for t in sh.p.values())
            n += sum(_nbytes(t) for st in sh.state.values()
                     for t in st.values())
        return n

    def _record_between_steps(self):
        devs = {self.model.device} | {t.device for sh in self._shards.values()
                                      for t in sh.p.values()}
        cuda = {torch.cuda.current_device() if d.index is None else d.index
                for d in devs if d.type == "cuda"}
        self.between_steps.append({
            "held": self.held_bytes(),
            "allocated": (sum(torch.cuda.memory_allocated(i) for i in cuda)
                          if cuda else None)})

    # ------------------------------------------------------------- step
    def _rows(self, ds):
        """This process's rows of the global batch: block p of the
        mesh's P processes."""
        n = ds.num_examples()
        if self._xp is None:
            return 0, n
        P, p = self._xp.size, self._xp.index
        if n % P:
            raise ValueError(f"a batch of {n} rows does not split over "
                             f"{P} processes")
        b = n // P
        return p * b, b

    def _dense_step(self, it, ds, rng):
        """One dense step on the compute copy (gathered here; released
        by `fit` after the step's listeners). Returns (loss, the
        diagnostics' packed stats or None)."""
        from deeplearning4j_tpu_torch.parallel.trainer import global_pass
        model = self.model
        self._materialize()
        off, b = self._rows(ds)
        x, y, _ = model._batch(ds, None)
        if off or b != ds.num_examples():
            sl = slice(off, off + b)
            x = [t[sl] for t in x] if isinstance(x, list) else x[sl]
            y = [t[sl] for t in y] if isinstance(y, list) else y[sl]
        acts = model._act_stats()
        loss, grads, new_state = global_pass(
            model, x, y, rng, acts, off, ds.num_examples(), self._xp)
        grads = model._normalize_gradients(grads)
        diag = model._diag
        params = _params_of(model)
        if diag is not None:
            flat = snapshot([t for lp in params.values()
                             for t in lp.values()])
            it_ = iter(flat)
            old = {lk: {pn: next(it_) for pn in lp}
                   for lk, lp in params.items()}
            skip = diag.config.watchdog == "skip"
            upd_old = snapshot(self._state_leaves() if skip else [])
        self._update(it, grads)
        dv = None
        if diag is not None:
            cd = model.dtype.compute_dtype
            gtree = {lk: {pn: (grads.get(id(p)) if grads.get(id(p))
                               is not None else torch.zeros_like(p, dtype=cd))
                          for pn, p in lp.items()}
                     for lk, lp in params.items()}
            dv, ok = diag.collect("fit", params_new=params, params_old=old,
                                  grads=gtree, loss=loss, acts=acts)
            if skip:
                keep_finite_(ok, [t for lp in params.values()
                                  for t in lp.values()],
                             [t for lp in old.values() for t in lp.values()])
                keep_finite_(ok, self._state_leaves(), upd_old)
                live = model.net_state
                new_state = {k: {n: (torch.where(ok, t, live[k][n])
                                     if n in live.get(k, {}) else t)
                                 for n, t in st.items()}
                             for k, st in new_state.items()}
        self._scatter()
        model._commit_state(new_state)
        return loss, dv

    def _state_leaves(self):
        """Every live updater-state tensor: the replicated leaves' and
        this process's shards'."""
        out = [t for lst in self.model.updater_state.values()
               for slots in lst.values() for t in slots.values()]
        for sh in self._shards.values():
            out += [t for j in sorted(sh.state)
                    for t in sh.state[j].values()]
        return out

    @torch.no_grad()
    def _update(self, it, grads):
        """Every owner's update of its shards (and every process's of
        the replicated leaves) through the container's update groups:
        fused Adam over a packed run's leaves and shards in one launch,
        the updater rule per leaf otherwise; then the shards gathered
        into the compute copy and the constraints applied to it."""
        model = self.model
        cd = model.dtype.compute_dtype
        for group in model._update_groups():
            updater = model.updater_of(model.layers[group[0]])
            ps, gs_, states = [], [], []
            for i in group:
                lk = model.layer_keys[i]
                for pn, p in model.layers[i].jax_param_map().items():
                    g = grads.get(id(p))
                    if g is None:
                        g = torch.zeros_like(p, dtype=cd)
                    sh = self._shards.get((lk, pn))
                    if sh is None:
                        ps.append(p)
                        gs_.append(g)
                        states.append(model.updater_state[lk][pn])
                        continue
                    g_parts = g.chunk(sh.k, dim=sh.dim)
                    for j in sorted(sh.p):
                        ps.append(sh.p[j])
                        gs_.append(g_parts[j].to(sh.p[j].device)
                                   .contiguous())
                        states.append(sh.state[j])
            if not ps:
                continue
            if type(updater) is Adam and len(ps) > 1 and len(
                    {t.device for t in ps}) == 1:
                adam_update_packed(updater, ps, gs_,
                                   [s["m"] for s in states],
                                   [s["v"] for s in states], it)
            else:
                for p, g, st in zip(ps, gs_, states):
                    upd, new = updater.apply(g.to(p.dtype), st, it)
                    p.sub_(upd.to(p.dtype))
                    st.update(new)
        self._materialize()
        model._apply_constraints()
        model.params_changed()

    # ------------------------------------------------------ threshold
    def _threshold_trainer(self):
        """`ParallelTrainer`'s threshold exchange over the data axis's
        devices (the model index 0 line), under this trainer's key and
        names."""
        if self._thr is None:
            from deeplearning4j_tpu_torch.parallel.mesh import Mesh
            from deeplearning4j_tpu_torch.parallel.trainer import (
                ParallelTrainer)
            devs = np.empty(self.n_data, dtype=object)
            devs[:] = list(self.mesh.axis_devices(self.data_axis)) \
                if self.data_axis in self.mesh.shape else [self.model.device]
            ranks = (np.array(self.mesh.axis_ranks(self.data_axis))
                     if self.mesh.ranks is not None else None)
            sub = Mesh(devs, (self.data_axis,), ranks)
            self._thr = ParallelTrainer(
                self.model, sub, data_axis=self.data_axis,
                gradient_sharing="threshold", bucketed=self.bucketed,
                threshold_config=self.threshold_config, stats=self.stats)
            self._thr._rng_offset = 5
            self._thr._trainer_name = "sharded"
        return self._thr

    # ---------------------------------------------------------- resume
    def _restore_fault_state(self, arrays, meta):
        """`fault.resume` hook: the threshold exchange's residual, τ and
        per-replica updater stack (re-sharded on a replica-count
        change); a dense checkpoint's state is the model's own."""
        if meta.get("kind") != "threshold" or not arrays:
            return
        self._threshold_trainer()._restore_fault_state(arrays, meta)

    def resume(self, directory, *, iterator=None):
        """Restore the model and this trainer's state from the newest
        valid checkpoint under `directory`; a following `fit()`
        continues the interrupted run. Returns the model."""
        from deeplearning4j_tpu_torch import fault
        model, _ = fault.resume(directory, model=self.model, trainer=self,
                                iterator=iterator)
        return model

    # -------------------------------------------------------- evaluate
    def evaluate(self, data, labels=None, *, batch_size: int = 32,
                 evaluation=None):
        """Evaluation with the trained params: every batch's forward, a
        ragged tail zero-padded to the data-axis multiple and the padded
        rows sliced off before scoring."""
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
        from deeplearning4j_tpu_torch.parallel.trainer import (
            _mesh_evaluate, _require_single_process)
        _require_single_process("ShardedParallelTrainer.evaluate()")
        model = self.model
        if self._is_graph and (len(model.conf.network_inputs) != 1
                               or len(model.conf.network_outputs) != 1):
            raise NotImplementedError(
                "ShardedParallelTrainer.evaluate supports single-"
                "input single-output graphs; evaluate multi-io "
                "graphs on the host via model.evaluate()")
        iterator = as_iterator(data, labels, batch_size=batch_size)
        if hasattr(iterator, "reset"):
            iterator.reset()
        merged = evaluation if evaluation is not None else Evaluation()

        def forward(x):
            with torch.no_grad():
                return model._eval_output(x, None).float().cpu().numpy()
        return _mesh_evaluate(iterator, merged, self.n_data, forward)

    # ------------------------------------------------------------- fit
    def fit(self, data, labels=None, *, epochs: int = 1, batch_size: int = 32):
        if self.gradient_sharing == "threshold":
            return self._fit_threshold(data, labels, epochs, batch_size)
        from deeplearning4j_tpu_torch.parallel import gradient_sharing as gs
        model = self.model
        monitor.attach_master_stats(self.stats)
        dense_b = gs.exchange_wire_bytes(
            _params_of(model), "dense", grad_dtype=model.dtype.compute_dtype)
        if self.stats is not None:
            with self.stats.time_phase("broadcast"):
                self._place()
                self._sync()
        else:
            self._place()
        iterator = as_iterator(data, labels, batch_size=batch_size)
        listeners = ComposedListeners(model.listeners
                                      + monitor.extra_listeners())
        rng_root = prng.key(model.conf.seed + 5)
        eager_loss = bool(model.listeners) or self.stats is not None
        loss = None

        def live_state():
            return {"params": _params_of(model),
                    "net_state": model.net_state,
                    "updater_state": self._full_state(),
                    "trainer_meta": {"kind": "sync_dense",
                                     "trainer": "sharded",
                                     "n_workers": self.n_data}}

        model._live_state_provider = live_state
        try:
            listeners.on_fit_start(model)
            for _ in range(epochs):
                listeners.on_epoch_start(model, model.epoch_count)
                if hasattr(iterator, "reset"):
                    iterator.reset()
                for ds in iterator:
                    it = model.iteration_count
                    t0 = time.perf_counter()
                    loss, dv = self._dense_step(it, ds,
                                                prng.fold_in(rng_root, it))
                    gs.record_exchange("dense", dense_b, dense_b, 1,
                                       trainer="sharded")
                    if self.stats is not None:
                        self._sync()
                        self.stats.record("sync_step",
                                          time.perf_counter() - t0,
                                          iteration=it)
                        self.stats.next_round()
                    if eager_loss:
                        model.score_value = float(loss)
                    rows = process_if_due(model, dv, "fit", it)
                    listeners.iteration_done(
                        model, it, model.epoch_count,
                        model.score_value if eager_loss else float("nan"),
                        batch_size=ds.num_examples(),
                        diagnostics=rows[-1] if rows else None)
                    model.iteration_count += 1
                    self._release()
                    self._record_between_steps()
                self._materialize()
                listeners.on_epoch_end(model, model.epoch_count)
                model.epoch_count += 1
            listeners.on_fit_end(model)
        finally:
            model._live_state_provider = None
            self._unplace()
        if loss is not None and not eager_loss:
            model.score_value = float(loss)
        return model

    def _fit_threshold(self, data, labels, epochs, batch_size):
        return self._threshold_trainer().fit(data, labels, epochs=epochs,
                                             batch_size=batch_size)

    def _sync(self):
        for d in {str(d) for d in self.mesh.devices.flat}:
            d = torch.device(d)
            if d.type == "cuda":
                torch.cuda.synchronize(d)
