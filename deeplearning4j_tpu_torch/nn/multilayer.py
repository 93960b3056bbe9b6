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
arithmetic). Updates happen in place.

Not ported yet, and refused rather than ignored: steps_per_execution >
1, masks, non-zero l1/l2, updater rules other than Sgd and Adam,
learning-rate schedules. Truncated BPTT and the line-search solvers
have no setting in the port at all.
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


class MultiLayerNetwork(nn.Module):
    def __init__(self, layers: List[nn.Module], *, device="cuda"):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.dtype = torch.float32     # the fp32 policy (mixed_bf16: later)
        self.device = resolve_device(device)
        super().to(self.device)
        self.iteration_count = 0
        self.epoch_count = 0
        self.score_value = float("nan")
        # {"<layer>": {param name: updater state}}, keyed like the JAX
        # net's `updater_state` (Adam: {"m", "v"}; Sgd: {})
        self.updater_state: Dict[str, Dict[str, Dict[str, torch.Tensor]]] = {
            str(i): {name: self.updater_of(layer).init_state(t)
                     for name, t in layer.jax_param_map().items()}
            for i, layer in enumerate(self.layers) if layer.jax_param_map()}

    def to(self, device):
        """Move every parameter, buffer and updater state to `device`
        (resolved like an entry point's `device=`)."""
        self.device = resolve_device(device)
        super().to(self.device)
        self.updater_state = {
            lk: {pk: {sk: t.to(self.device) for sk, t in st.items()}
                 for pk, st in lst.items()}
            for lk, lst in self.updater_state.items()}
        return self

    @staticmethod
    def updater_of(layer):
        return layer.updater or Sgd(1e-3)

    def init_carries(self, batch: int) -> Dict[str, object]:
        return {str(i): layer.init_carry(batch, self.dtype, self.device)
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
        h = x
        new_carries = {}
        for i, layer in enumerate(self.layers[:upto]):
            if carries is not None and isinstance(layer, BaseRecurrentLayer):
                carry = carries.get(str(i))
                if carry is None:
                    carry = layer.init_carry(h.shape[0], self.dtype,
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

    def output(self, x):
        """Forward pass to the final activation (the JAX `output`, no
        mask): token ids [B, T] -> [B, T, V] softmax for the LM."""
        x = torch.as_tensor(x, device=self.device)
        h, _ = self._forward_core(x)
        return h.float()

    # --------------------------------------------------------------- loss
    def _loss_fn(self, x, y):
        """The output layer's loss on the forward through the layers
        before it (the JAX `_loss_fn` without diagnostics, MoE aux loss
        or weight noise; regularization is zero)."""
        out = self.layers[-1]
        if not isinstance(out, BaseOutputLayerMixin):
            raise ValueError(f"the last layer ({type(out).__name__}) has no "
                             f"loss; fit needs an output layer")
        for layer in self.layers:
            if layer.l1 or layer.l2 or layer.l1_bias or layer.l2_bias:
                raise NotImplementedError(
                    "l1/l2 regularization is not ported yet")
        h, _ = self._forward(x, upto=len(self.layers) - 1)
        return out.compute_loss(h, y)

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
    def _apply_updates(self, step: int):
        """One update of every param from its `.grad` (the JAX
        `_apply_updates`): an Adam group is one fused-Adam call over all
        its leaves (one kernel launch on the card); any other rule
        applies per leaf. Grads are upcast to the param dtype."""
        for group in self._update_groups():
            updater = self.updater_of(self.layers[group[0]])
            ps, gs, states = [], [], []
            for i in group:
                for name, p in self.layers[i].jax_param_map().items():
                    ps.append(p)
                    gs.append(torch.zeros_like(p) if p.grad is None
                              else p.grad)
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
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def _labels(self, y) -> torch.Tensor:
        return torch.as_tensor(np.asarray(y), dtype=self.dtype,
                               device=self.device)

    def _fit_step(self, x, y):
        """forward + loss + backward + update on one minibatch; params
        take gradients for this step only."""
        params = list(self.parameters())
        try:
            for p in params:
                p.requires_grad_(True)
            loss = self._loss_fn(x, y)
            loss.backward()
            self._apply_updates(self.iteration_count)
        finally:
            for p in params:
                p.requires_grad_(False)
                p.grad = None
        self.score_value = float(loss.detach())
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
        return float(self._loss_fn(self._features(dataset.features),
                                   self._labels(dataset.labels)))
