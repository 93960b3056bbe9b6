"""Container-level pipeline parallelism: a MultiLayerNetwork stage-
partitioned over the "pipe" mesh axis (counterpart of
`deeplearning4j_tpu/parallel/pipeline_container.py`).

The network splits into prolog | homogeneous run | epilog, the run
being the longest streak of consecutive layers with one configuration
and param shapes (`find_homogeneous_run`: the repeated transformer
blocks), which must divide into mesh[pipe] stages of `run / S` blocks.
The prolog and the epilog (embedding, positional encoding, the output
loss) run on the compute device as the container runs them, and the
run goes through `pipeline.pipeline_forward`'s GPipe schedule, stage s
calling its blocks on its device. The loss mirrors the container's
`_loss_fn` (the same per-layer keys, preprocessors, regularization and
auxiliary losses), the gradients come back per layer through autograd,
and the container's own `_update` (fused Adam over each packed run,
constraints, running state, diagnostics) applies them unchanged, so the
step is the container's step but for the schedule.
"""

from __future__ import annotations

import json
import time
from typing import Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.datasets.iterator import as_iterator
from deeplearning4j_tpu_torch.monitor.diagnostics import process_if_due
from deeplearning4j_tpu_torch.optimize.listeners import ComposedListeners
from deeplearning4j_tpu_torch.parallel.pipeline import (
    bubble_share,
    pipeline_forward,
)


def _layer_signature(layer):
    """Full config equality plus param shapes: two layers with equal
    shapes but other activations or head counts do not merge."""
    try:
        conf = json.dumps(layer.to_dict(), sort_keys=True, default=str)
    except Exception:  # noqa: BLE001 — a layer without a dict form
        conf = repr(layer)
    return (layer.layer_name, conf,
            tuple(sorted((pn, tuple(t.shape))
                         for pn, t in layer.jax_param_map().items())))


def find_homogeneous_run(model) -> Tuple[int, int]:
    """[start, stop) of the longest streak of consecutive layers with an
    identical signature (the pipelineable body)."""
    best = (0, 0)
    i, n = 0, len(model.layers)
    while i < n:
        sig = _layer_signature(model.layers[i])
        j = i + 1
        while j < n and _layer_signature(model.layers[j]) == sig:
            j += 1
        if j - i > best[1] - best[0]:
            best = (i, j)
        i = j
    return best


class PipelineParallelTrainer:
    """GPipe training of a MultiLayerNetwork over `mesh[pipe_axis]`;
    `microbatches` is the GPipe M (bubble share (S-1)/(M+S-1)), and the
    global batch must divide by it (times the data axis's size under
    `data_axis`)."""

    def __init__(self, model, mesh, *, pipe_axis: str = "pipe",
                 data_axis: Optional[str] = None, microbatches: int = 4,
                 run: Optional[Tuple[int, int]] = None, stats=None):
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
        self.stats = stats
        if isinstance(model, ComputationGraph):
            raise NotImplementedError(
                "PipelineParallelTrainer stages MultiLayerNetwork stacks; "
                "for a ComputationGraph, pipeline its repeated-block "
                "subgraph as a MultiLayerNetwork or use DP x TP "
                "(ShardedParallelTrainer)")
        self.model = model
        self.mesh = mesh
        self.pipe_axis = pipe_axis
        if data_axis is not None and data_axis not in mesh.shape:
            raise ValueError(
                f"data_axis {data_axis!r} is not a mesh axis "
                f"{tuple(mesh.shape)} — a silent fallback would leave "
                "the batch replicated over that axis and mis-scale "
                "gradients")
        self.data_axis = data_axis
        self.microbatches = int(microbatches)
        if self.microbatches < 1:
            raise ValueError(
                f"microbatches must be >= 1; got {microbatches}")
        S = int(mesh.shape[pipe_axis])
        self.n_stages = S
        r0, r1 = run if run is not None else find_homogeneous_run(model)
        if (r1 - r0) < S:
            raise ValueError(
                f"longest homogeneous layer run [{r0}, {r1}) has "
                f"{r1 - r0} blocks — fewer than {S} pipeline stages. "
                "Reduce the pipe axis or deepen the repeated body.")
        if (r1 - r0) % S:
            raise ValueError(
                f"homogeneous run of {r1 - r0} blocks does not divide "
                f"into {S} stages; choose S | run length")
        for i in range(r0 + 1, r1):
            if i in model.conf.input_preprocessors:
                raise ValueError(
                    f"input preprocessor at layer {i} sits inside the "
                    "pipelined run; preprocessors are only supported in "
                    "the prolog/epilog")
        state = model.net_state
        for i in range(r0, r1):
            layer = model.layers[i]
            if getattr(layer, "dropout", None) or \
                    getattr(layer, "weight_noise", None):
                raise ValueError(
                    f"layer {i} ({layer.layer_name}) uses dropout/weight "
                    "noise inside the pipelined run — per-block rng "
                    "threading is not supported on this path; move the "
                    "stochastic layer out of the run or disable it")
            if state.get(str(i)) or \
                    layer.layer_name == "mixture_of_experts":
                raise ValueError(
                    f"layer {i} ({layer.layer_name}) is stateful (running "
                    "stats / aux losses) inside the pipelined run — the "
                    "stage function discards per-block state; keep "
                    "stateful layers in the prolog/epilog")
        self.run = (r0, r1)

    # ------------------------------------------------------ batch shaping
    def _data_shards(self) -> int:
        return (1 if self.data_axis is None
                else int(self.mesh.shape[self.data_axis]))

    def _batch_multiple(self) -> int:
        """Every batch reshapes to [microbatches, shard, ...]: the batch
        must be a multiple of this."""
        return self.microbatches * self._data_shards()

    def _validate_batch(self, n: int, what: str):
        M, shards = self.microbatches, self._data_shards()
        if n % M:
            raise ValueError(
                f"{what} of {n} examples does not divide into "
                f"microbatches={M}; choose a batch size that is a "
                f"multiple of {self._batch_multiple()} (microbatches x "
                f"mesh['{self.data_axis}']), or drop the ragged tail")
        if (n // M) % shards:
            raise ValueError(
                f"{what} of {n} examples: per-microbatch size "
                f"{n // M} does not divide over the {shards}-way "
                f"'{self.data_axis}' mesh axis; choose a batch size "
                f"that is a multiple of {self._batch_multiple()} "
                f"(microbatches x mesh['{self.data_axis}'])")

    def bubble_share(self) -> float:
        """The schedule's idle share, (S - 1) / (M + S - 1)."""
        return bubble_share(self.n_stages, self.microbatches)

    # -------------------------------------------------------- the run
    def _stages(self):
        """Per stage: {layer index: {param name: tensor}} of its
        blocks."""
        r0, r1 = self.run
        per = (r1 - r0) // self.n_stages
        return [{i: dict(self.model.layers[i].named_parameters())
                 for i in range(r0 + s * per, r0 + (s + 1) * per)}
                for s in range(self.n_stages)]

    def _stage_fn(self, train: bool):
        model = self.model

        def stage(sp, h):
            for i, params in sp.items():
                layer = model.layers[i]
                own = dict(layer.named_parameters())
                if all(params[n] is p for n, p in own.items()):
                    if train:
                        h = model._call_layer(str(i), layer, h, train=True,
                                              rng=None, mask=None,
                                              new_state=None)
                    else:
                        h = layer(h, train=False, rng=None, mask=None)
                else:
                    # the stage's copy on another device
                    h = torch.func.functional_call(
                        layer, params, (h,),
                        dict(train=train, rng=None, mask=None), strict=False)
            return h
        return stage

    def _run(self, h, train: bool):
        return pipeline_forward(self._stage_fn(train), self._stages(), h,
                                self.mesh, pipe_axis=self.pipe_axis,
                                microbatches=self.microbatches,
                                data_axis=self.data_axis)

    # ------------------------------------------------------------ loss
    def _pp_loss(self, x, y, rng, new_state):
        """The container's `_loss_fn` with the run executed by the GPipe
        schedule: the prolog's and epilog's layers under their keys
        `fold_in(rng, i)`, the run's blocks keyless (no stochastic layer
        may sit there)."""
        model = self.model
        r0, r1 = self.run
        n = len(model.layers)
        out = model.layers[-1]
        model._check_trainable()
        h, _, mask = model._forward(x, upto=r0, train=True, rng=rng,
                                    new_state=new_state)
        if mask is not None:
            raise ValueError("masks are not supported under PP")
        h = self._run(h, train=True)
        pre = model.conf.input_preprocessors
        for i in range(r1, n - 1):
            layer = model.layers[i]
            if i in pre:
                h, mask = model._pre_process(i, h, mask)
            h = model._call_layer(str(i), layer, h, train=True, rng=rng,
                                  mask=mask, new_state=new_state)
            mask = layer.forward_mask(mask)
        if n - 1 in pre:
            h, mask = model._pre_process(n - 1, h, mask)
        loss = model._output_loss(str(n - 1), out, h, y, mask, train=True,
                                  rng=rng)
        return model.dtype.cast_output(loss) + (
            model._regularization() + model._pop_aux(new_state))

    def _step(self, it, x, y, rng):
        model = self.model
        loss, grads, new_state = model._loss_and_grads(
            lambda st: self._pp_loss(x, y, rng, st))
        dv = model._update(it, model._normalize_gradients(grads), new_state,
                           loss, None, name="pipeline")
        return loss, dv

    # -------------------------------------------------------- evaluate
    @torch.no_grad()
    def _forward(self, x):
        model = self.model
        r0, r1 = self.run
        h, _, mask = model._forward(x, upto=r0)
        h = self._run(h, train=False)
        pre = model.conf.input_preprocessors
        for i in range(r1, len(model.layers)):
            layer = model.layers[i]
            if i in pre:
                h, mask = model._pre_process(i, h, mask)
            h = layer(h, train=False, rng=None, mask=mask)
            mask = layer.forward_mask(mask)
        return model.dtype.cast_output(h)

    def evaluate(self, data, labels=None, *, batch_size: int = 32,
                 evaluation=None):
        """Evaluation through the same pipelined forward the trainer
        uses; a ragged tail pads (repeating its last row) to the
        microbatch grid and is sliced after the forward."""
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
        model = self.model
        iterator = as_iterator(data, labels, batch_size=batch_size)
        if hasattr(iterator, "reset"):
            iterator.reset()
        ev = evaluation if evaluation is not None else Evaluation()
        M = self._batch_multiple()
        for ds in iterator:
            x = np.asarray(ds.features)
            n_real = x.shape[0]
            pad = (-n_real) % M
            if pad:
                x = np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])
            out = self._forward(model._inputs(x))[:n_real]
            ev.eval(np.asarray(ds.labels), out.float().cpu().numpy())
        return ev

    # ------------------------------------------------------------- fit
    def fit(self, data, labels=None, *, epochs: int = 1,
            batch_size: int = 32):
        model = self.model
        self._validate_batch(int(batch_size), "batch_size")
        monitor.attach_master_stats(self.stats)
        iterator = as_iterator(data, labels, batch_size=batch_size)
        listeners = ComposedListeners(model.listeners
                                      + monitor.extra_listeners())

        def live_state():
            return {"params": {k: layer.jax_param_map()
                               for k, layer in model.keyed()
                               if layer.jax_param_map()},
                    "net_state": model.net_state,
                    "updater_state": model.updater_state,
                    "trainer_meta": {"kind": "pipeline",
                                     "trainer": "pipeline",
                                     "n_stages": self.n_stages}}

        model._live_state_provider = live_state
        try:
            listeners.on_fit_start(model)
            for _ in range(epochs):
                listeners.on_epoch_start(model, model.epoch_count)
                if hasattr(iterator, "reset"):
                    iterator.reset()
                for ds in iterator:
                    if ds.features_mask is not None or \
                            ds.labels_mask is not None:
                        raise ValueError("masks are not supported under PP")
                    self._validate_batch(ds.num_examples(), "fit batch")
                    it = model.iteration_count
                    x, y, _ = model._batch(ds, None)
                    t0 = time.perf_counter()
                    loss, dv = self._step(it, x, y, model._step_key(it))
                    model.score_value = float(loss)
                    if self.stats is not None:
                        self.stats.record("sync_step",
                                          time.perf_counter() - t0,
                                          iteration=it)
                        self.stats.next_round()
                    rows = process_if_due(model, dv, "pipeline", it)
                    listeners.iteration_done(
                        model, it, model.epoch_count, model.score_value,
                        batch_size=ds.num_examples(),
                        diagnostics=rows[-1] if rows else None)
                    model.iteration_count += 1
                listeners.on_epoch_end(model, model.epoch_count)
                model.epoch_count += 1
            listeners.on_fit_end(model)
        finally:
            model._live_state_provider = None
        return model

    def resume(self, directory, *, iterator=None):
        """Restore the model's full training state from the newest valid
        checkpoint under `directory` (the pipelined step keeps the
        container's per-layer state, so a model-level restore is
        complete); a following `fit()` continues the run."""
        from deeplearning4j_tpu_torch import fault
        model, _ = fault.resume(directory, model=self.model, trainer=self,
                                iterator=iterator)
        return model
