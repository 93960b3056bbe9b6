"""ComputationGraph — the DAG container (counterpart of
`deeplearning4j_tpu/nn/graph.py`: `GraphNode` :53,
`ComputationGraphConfiguration` :62-207, `GraphBuilder` :209-322,
`ComputationGraph` :324: `_forward_all` :451, `_loss_fn` :571,
`_packed_runs` :618, `_apply_updates` :638, `fit` :843, `output`
:1254, `feed_forward` :1270, `score` :1278, `evaluate*` :1287-1317,
`param_table` :1320, `num_params` :1327).

The configuration is the JAX one, key for key, so a JAX graph
`configuration.json` builds the port's graph and back. The container
shares params, running state, the dtype policy, the update, the fit
loop and evaluation with MultiLayerNetwork (`nn/container.py`); its own
part is the walk of the DAG. Its layers are the layer nodes in
topological order, keyed by node name: `updater_state`, `net_state`
and the carriers use the JAX graph's node-name keys, and layer node
`name` folds the step's threefry key with its position in
`conf.topo_order` (inputs and vertices count), as JAX does.

The forward walks the topological order unrolled: JAX runs maximal
single-consumer chains of identical layers as one `lax.scan`, which
gives the same numbers. Those chains are the graph's packed runs
(`_candidate_runs`, the JAX `scan_stack.build_graph_plan`): an Adam run
is one fused-Adam update. Several outputs sum their losses; under a
mixed policy inputs are cast to the compute dtype unless an embedding
takes them as ids (:477-482), the loss is fp32 and `output()` returns
fp32.

Recurrent nodes: `fit` takes truncated-BPTT steps over every [B, T, F]
input when configured (the JAX `_fit_tbptt` :1024-1066), and
`rnn_time_step` streams inference with every recurrent node's carry
kept across calls (:1094-1150).

Layerwise pretraining (`pretrain`, `nn/container.py`) walks only the
ancestors of each pretrained node (the JAX `pretrain` :1167-1252).

`fit` takes a `MultiDataSet` (or an iterator of them) for several
inputs and outputs (the JAX `fit` :844-1017), groups minibatches under
`steps_per_execution`, and runs the line-search solvers; `resume`,
`copy` and `set_param_table` are the container's.

Not ported, and refused by name: diagnostics, `gradient_sharing` other
than "dense" (in `fit` and `score`), and sequence parallelism inside a
graph (when it is built).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

import torch

from deeplearning4j_tpu_torch.datasets.iterator import as_iterator
from deeplearning4j_tpu_torch.datasets.multidataset import (
    MultiDataSet,
    MultiDataSetIterator,
)
from deeplearning4j_tpu_torch.nd.dtype import as_policy
from deeplearning4j_tpu_torch.nn.conf.builder import (
    CONFIG_FORMAT_VERSION,
    BackpropType,
    GradientNormalization,
    NeuralNetConfiguration,
    _diagnostics,
    check_format_version,
    infer_preprocessor,
)
from deeplearning4j_tpu_torch.nn.conf.graph import (
    GraphVertex,
    vertex_from_dict,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.container import (
    MIN_RUN,
    Container,
    layer_signature,
)
from deeplearning4j_tpu_torch.nn.layers.base import Layer, layer_from_dict
from deeplearning4j_tpu_torch.nn.layers.feedforward import (
    BaseOutputLayerMixin,
    EmbeddingLayer,
)
from deeplearning4j_tpu_torch.nn.layers.recurrent import BaseRecurrentLayer


@dataclasses.dataclass
class GraphNode:
    name: str
    kind: str  # "input" | "layer" | "vertex"
    layer: Optional[Layer] = None
    vertex: Optional[GraphVertex] = None
    inputs: List[str] = dataclasses.field(default_factory=list)
    preprocessor: Any = None  # an InputPreProcessor before a layer


class ComputationGraphConfiguration:
    """The serializable DAG (the JAX class's fields and defaults)."""

    def __init__(self):
        self.network_inputs: List[str] = []
        self.network_outputs: List[str] = []
        self.nodes: Dict[str, GraphNode] = {}
        self.input_types: Dict[str, InputType] = {}
        self.seed: int = 12345
        self.backprop_type = BackpropType.STANDARD
        self.tbptt_fwd_length = 20
        self.gradient_normalization = GradientNormalization.NONE
        self.gradient_normalization_threshold = 1.0
        self.max_norm: Optional[float] = None
        self.optimization_algo: str = "sgd"
        self.max_iterations: int = 5
        self.scan_layers: bool = True
        self.gradient_sharing: str = "dense"
        self.gradient_sharing_threshold: float = 1e-3
        self.dtype_policy = None
        self.diagnostics = None
        self.topo_order: List[str] = []

    @staticmethod
    def graph_builder(global_conf: Optional[NeuralNetConfiguration] = None
                      ) -> "GraphBuilder":
        return GraphBuilder(global_conf or NeuralNetConfiguration())

    def topological_sort(self) -> List[str]:
        """Kahn's algorithm from the network inputs, in the JAX order."""
        indeg = {n: 0 for n in self.nodes}
        dependents: Dict[str, List[str]] = {n: [] for n in self.nodes}
        for n, node in self.nodes.items():
            for src in node.inputs:
                indeg[n] += 1
                dependents[src].append(n)
        queue = list(self.network_inputs)
        order, seen = [], set()
        while queue:
            n = queue.pop(0)
            if n in seen:
                continue
            seen.add(n)
            order.append(n)
            for d in dependents[n]:
                indeg[d] -= 1
                if indeg[d] == 0:
                    queue.append(d)
        if len(order) != len(self.nodes):
            missing = set(self.nodes) - set(order)
            raise ValueError(
                f"Graph has a cycle or disconnected nodes: {missing}")
        return order

    def to_dict(self):
        return {
            "format": "deeplearning4j_tpu.ComputationGraphConfiguration",
            "format_version": CONFIG_FORMAT_VERSION,
            "network_inputs": self.network_inputs,
            "network_outputs": self.network_outputs,
            "seed": self.seed,
            "backprop_type": BackpropType(self.backprop_type).value,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "gradient_normalization": GradientNormalization(
                self.gradient_normalization).value,
            "gradient_normalization_threshold":
                self.gradient_normalization_threshold,
            "max_norm": self.max_norm,
            "optimization_algo": self.optimization_algo,
            "max_iterations": self.max_iterations,
            "scan_layers": self.scan_layers,
            "gradient_sharing": self.gradient_sharing,
            "gradient_sharing_threshold": self.gradient_sharing_threshold,
            "dtype_policy": (None if self.dtype_policy is None
                             else as_policy(self.dtype_policy).to_dict()),
            "diagnostics": _diagnostics(self.diagnostics),
            "input_types": {k: v.to_dict()
                            for k, v in self.input_types.items()},
            "nodes": [
                {"name": n.name, "kind": n.kind, "inputs": n.inputs,
                 "layer": None if n.layer is None else n.layer.to_dict(),
                 "vertex": None if n.vertex is None else n.vertex.to_dict(),
                 "preprocessor": (None if n.preprocessor is None
                                  else n.preprocessor.to_dict())}
                for n in self.nodes.values()],
            "topo_order": self.topo_order,
        }

    def to_json(self, **kw):
        return json.dumps(self.to_dict(), **kw)

    @staticmethod
    def from_dict(d: dict) -> "ComputationGraphConfiguration":
        from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
            preprocessor_from_dict)
        check_format_version(d, "ComputationGraphConfiguration")
        conf = ComputationGraphConfiguration()
        conf.network_inputs = list(d["network_inputs"])
        conf.network_outputs = list(d["network_outputs"])
        conf.seed = d.get("seed", 12345)
        conf.backprop_type = BackpropType(d.get("backprop_type", "standard"))
        conf.tbptt_fwd_length = d.get("tbptt_fwd_length", 20)
        conf.gradient_normalization = GradientNormalization(
            d.get("gradient_normalization", "none"))
        conf.gradient_normalization_threshold = d.get(
            "gradient_normalization_threshold", 1.0)
        conf.max_norm = d.get("max_norm")
        conf.optimization_algo = d.get("optimization_algo", "sgd")
        conf.max_iterations = d.get("max_iterations", 5)
        conf.scan_layers = d.get("scan_layers", True)
        conf.gradient_sharing = d.get("gradient_sharing", "dense")
        conf.gradient_sharing_threshold = d.get(
            "gradient_sharing_threshold", 1e-3)
        if d.get("dtype_policy") is not None:
            conf.dtype_policy = as_policy(d["dtype_policy"])
        conf.diagnostics = _diagnostics(d.get("diagnostics"))
        conf.input_types = {k: InputType.from_dict(v)
                            for k, v in d.get("input_types", {}).items()}
        for nd in d["nodes"]:
            conf.nodes[nd["name"]] = GraphNode(
                name=nd["name"], kind=nd["kind"], inputs=list(nd["inputs"]),
                layer=(layer_from_dict(nd["layer"]) if nd.get("layer")
                       else None),
                vertex=(vertex_from_dict(nd["vertex"]) if nd.get("vertex")
                        else None),
                preprocessor=(preprocessor_from_dict(nd["preprocessor"])
                              if nd.get("preprocessor") else None))
        conf.topo_order = list(d.get("topo_order")
                               or conf.topological_sort())
        return conf

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        return ComputationGraphConfiguration.from_dict(json.loads(s))


class GraphBuilder:
    """The fluent DAG builder: each layer gets the global configuration
    (updater, weight init, l1/l2, dropout, ...) as the JAX builder gives
    it, and `build()` infers types and n_in in topological order."""

    def __init__(self, global_conf: NeuralNetConfiguration):
        self._g = global_conf
        self._conf = ComputationGraphConfiguration()

    def add_inputs(self, *names: str) -> "GraphBuilder":
        for n in names:
            self._conf.network_inputs.append(n)
            self._conf.nodes[n] = GraphNode(name=n, kind="input")
        return self

    def set_input_types(self, *types: InputType) -> "GraphBuilder":
        for name, t in zip(self._conf.network_inputs, types):
            self._conf.input_types[name] = t
        return self

    def add_layer(self, name: str, layer: Layer,
                  *inputs: str) -> "GraphBuilder":
        layer = layer.clone()
        self._g.apply_global_defaults(layer)
        self._conf.nodes[name] = GraphNode(name=name, kind="layer",
                                           layer=layer, inputs=list(inputs))
        return self

    def add_vertex(self, name: str, vertex: GraphVertex,
                   *inputs: str) -> "GraphBuilder":
        self._conf.nodes[name] = GraphNode(name=name, kind="vertex",
                                           vertex=vertex, inputs=list(inputs))
        return self

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self._conf.network_outputs = list(names)
        return self

    def backprop_type(self, bptype, fwd_length: int = 20) -> "GraphBuilder":
        self._conf.backprop_type = BackpropType(bptype)
        self._conf.tbptt_fwd_length = fwd_length
        return self

    def scan_layers(self, flag: bool) -> "GraphBuilder":
        self._conf.scan_layers = bool(flag)
        return self

    def gradient_sharing(self, mode: str, threshold=None) -> "GraphBuilder":
        if mode not in ("dense", "threshold", "dense_rs", "threshold_rs"):
            raise ValueError(
                f"gradient_sharing must be dense|threshold|dense_rs|"
                f"threshold_rs, got {mode!r}")
        self._conf.gradient_sharing = mode
        if threshold is not None:
            self._conf.gradient_sharing_threshold = float(threshold)
        return self

    def dtype_policy(self, policy) -> "GraphBuilder":
        self._conf.dtype_policy = as_policy(policy)
        return self

    def diagnostics(self, spec) -> "GraphBuilder":
        self._conf.diagnostics = _diagnostics(spec)
        return self

    def build(self) -> ComputationGraphConfiguration:
        conf, g = self._conf, self._g
        conf.seed = g.seed_value
        conf.gradient_normalization = g.gradient_normalization_value
        conf.gradient_normalization_threshold = (
            g.gradient_normalization_threshold_value)
        conf.max_norm = g.max_norm_value
        conf.optimization_algo = g.optimization_algo_value
        conf.max_iterations = g.max_iterations_value
        if conf.dtype_policy is None:
            conf.dtype_policy = g.dtype_policy_value
        if conf.diagnostics is None:
            conf.diagnostics = g.diagnostics_value
        conf.topo_order = conf.topological_sort()
        if conf.input_types:
            types: Dict[str, InputType] = dict(conf.input_types)
            for name in conf.topo_order:
                node = conf.nodes[name]
                if node.kind == "input":
                    continue
                in_types = [types[i] for i in node.inputs if i in types]
                if len(in_types) != len(node.inputs):
                    continue    # not inferable: the layer's n_in stands
                if node.kind == "vertex":
                    types[name] = node.vertex.get_output_type(in_types)
                    continue
                it = in_types[0]
                if node.preprocessor is None:
                    node.preprocessor = infer_preprocessor(it, node.layer)
                if node.preprocessor is not None:
                    it = node.preprocessor.get_output_type(it)
                node.layer.set_n_in(it, override=getattr(
                    node.layer, "n_in", 0) in (0, None))
                types[name] = node.layer.get_output_type(it)
        return conf


class ComputationGraph(Container):
    def __init__(self, conf: ComputationGraphConfiguration, *,
                 device="cuda", dtype_policy=None):
        """A graph from its configuration (its layers become the graph's,
        as in JAX; a conf whose layers already belong to a net is copied
        first). Params are zeros (norm gains ones) until `init` draws
        them or a loader fills them."""
        super().__init__()
        if any(getattr(n.layer, "_in_net", False)
               for n in conf.nodes.values()):
            conf = ComputationGraphConfiguration.from_dict(conf.to_dict())
        sp = [n for n, node in conf.nodes.items()
              if getattr(node.layer, "sequence_parallel", None)]
        if sp:
            raise NotImplementedError(
                f"sequence parallelism inside a ComputationGraph (nodes "
                f"{sp}) is not ported; build the model as a "
                f"MultiLayerNetwork")
        order = conf.topo_order or conf.topological_sort()
        names = [n for n in order if conf.nodes[n].kind == "layer"]
        self._setup(conf, [conf.nodes[n].layer for n in names], names,
                    {n: i for i, n in enumerate(order)}, device,
                    dtype_policy)
        self.topo_order = order
        self.output_layer_names = [
            n for n in conf.network_outputs
            if conf.nodes[n].kind == "layer"
            and isinstance(conf.nodes[n].layer, BaseOutputLayerMixin)]
        self._position = {n: i for i, n in enumerate(names)}
        # the embedding that takes each network input as token ids
        self._id_consumer = {
            inp: next((node.layer for node in conf.nodes.values()
                       if isinstance(node.layer, EmbeddingLayer)
                       and inp in node.inputs), None)
            for inp in conf.network_inputs}

    # ----------------------------------------------------------- forward
    def _forward_all(self, xs, *, train=False, rng=None, masks=None,
                     stop_at_loss=False, new_state=None, carries=None):
        """Walk the topological order. Returns (activations by node,
        {output layer: (its input, its mask)} when `stop_at_loss`, masks
        by node). With `carries` (a dict by node name, written in place)
        the recurrent nodes run from their carries and leave the new
        ones there."""
        masks = list(masks) if masks else [None] * len(xs)
        acts, mask_map, preouts = {}, {}, {}
        for i, name in enumerate(self.conf.network_inputs):
            x = xs[i]
            if self._id_consumer[name] is None:
                # token ids pass uncast: a bf16 round corrupts ids > 256
                x = self.dtype.cast_compute(x)
            acts[name] = x
            mask_map[name] = masks[i] if i < len(masks) else None
        for name in self.topo_order:
            node = self.conf.nodes[name]
            if node.kind == "input":
                continue
            in_acts = [acts[s] for s in node.inputs]
            in_masks = [mask_map.get(s) for s in node.inputs]
            if node.kind == "vertex":
                acts[name] = node.vertex.forward(in_acts, masks=in_masks,
                                                 train=train)
                mask_map[name] = node.vertex.forward_mask(in_masks)
                continue
            h, mask = in_acts[0], in_masks[0]
            if node.preprocessor is not None:
                h = node.preprocessor.pre_process(h, mask)
                mask = node.preprocessor.process_mask(mask)
            if stop_at_loss and name in self.output_layer_names:
                preouts[name] = (h, mask)
                continue
            if carries is not None and isinstance(node.layer,
                                                  BaseRecurrentLayer):
                acts[name], carries[name] = self._call_with_carry(
                    name, node.layer, h, carries.get(name), train=train,
                    rng=rng, mask=mask)
            else:
                acts[name] = self._call_layer(name, node.layer, h,
                                              train=train, rng=rng,
                                              mask=mask, new_state=new_state)
            mask_map[name] = node.layer.forward_mask(mask)
        return acts, preouts, mask_map

    def _loss_fn(self, xs, ys, fmasks=None, lmasks=None, *, train=False,
                 rng=None, new_state=None, carries=None, carries_out=None):
        """The sum of every output layer's loss on the forward to it, plus
        the l1/l2 penalty and the training forward's auxiliary losses
        (the JAX `_loss_fn` without diagnostics); an output's label mask
        defaults to the mask that
        reached it. With `carries` (truncated BPTT) the recurrent nodes
        run from them and leave their new carries in `carries_out`."""
        if not self.output_layer_names:
            raise ValueError("fit needs an output layer among the graph's "
                             "outputs")
        self._check_trainable()
        fmasks = _as_list(fmasks)
        lmasks = _as_list(lmasks) or [None] * len(ys)
        c = None if carries is None else dict(carries)
        _, preouts, _ = self._forward_all(
            xs, train=train, rng=rng, masks=fmasks, stop_at_loss=True,
            new_state=new_state, carries=c)
        if carries_out is not None and c is not None:
            carries_out.update(c)
        total = 0.0
        for oi, name in enumerate(self.output_layer_names):
            h, mask = preouts[name]
            lmask = lmasks[oi] if lmasks[oi] is not None else mask
            total = total + self._output_loss(
                name, self.conf.nodes[name].layer, h, ys[oi], lmask,
                train=train, rng=rng)
        return self.dtype.cast_output(total + self._regularization()
                                      + self._pop_aux(new_state))

    def _output_positions(self):
        return [self._position[n] for n in self.output_layer_names]

    def _refusals(self):
        bad = super()._refusals()
        if self.conf.gradient_sharing != "dense":
            bad.append(f"gradient_sharing {self.conf.gradient_sharing}")
        return bad

    # ------------------------------------------------------------ updates
    def _candidate_runs(self) -> List[List[int]]:
        """Maximal single-consumer chains of layer nodes with one
        signature, in topological order (the JAX
        `scan_stack.build_graph_plan`): no preprocessor, no output layer,
        no network output inside a chain, each link the only input of
        the next."""
        conf = self.conf
        consumers: Dict[str, List[str]] = {n: [] for n in conf.nodes}
        for name, node in conf.nodes.items():
            for src in node.inputs:
                consumers[src].append(name)

        def signature(node):
            if (node.kind != "layer" or node.preprocessor is not None
                    or node.name in self.output_layer_names):
                return None
            return layer_signature(node.layer)

        runs, taken = [], set()
        for name in self.topo_order:
            node = conf.nodes[name]
            sig = signature(node)
            if name in taken or sig is None:
                continue
            chain, cur = [name], node
            while True:
                outs = consumers[cur.name]
                if len(outs) != 1 or cur.name in conf.network_outputs:
                    break
                nxt = conf.nodes[outs[0]]
                if nxt.inputs != [cur.name] or signature(nxt) != sig:
                    break
                chain.append(nxt.name)
                cur = nxt
            if len(chain) >= MIN_RUN:
                runs.append([self._position[n] for n in chain])
                taken.update(chain)
        return runs

    # ------------------------------------------------------------ inputs
    def _features(self, x) -> List[torch.Tensor]:
        """One tensor per network input (`x` a list or tuple of arrays,
        or one array for a one-input graph)."""
        xs = list(x) if isinstance(x, (list, tuple)) else [x]
        if len(xs) != len(self.conf.network_inputs):
            raise ValueError(f"the graph has {len(self.conf.network_inputs)}"
                             f" inputs; got {len(xs)}")
        return [self._features_for(a, self._id_consumer[name])
                for a, name in zip(xs, self.conf.network_inputs)]

    def _labels(self, y) -> List[torch.Tensor]:
        ys = list(y) if isinstance(y, (list, tuple)) else [y]
        return [Container._labels(self, a) for a in ys]

    # -------------------------------------------------------- entry points
    def _batch(self, ds, data_format=None):
        """A `DataSet` (one input, one output) or a `MultiDataSet` as the
        step's lists of tensors; the masks (lists) only where one is
        set."""
        if isinstance(ds, MultiDataSet):
            xs, ys = list(ds.features), list(ds.labels)
            fms = list(ds.features_masks or [None] * len(xs))
            lms = list(ds.labels_masks or [None] * len(ys))
        else:
            if ds.labels is None:
                raise ValueError("fit needs labels")
            xs, ys = [ds.features], [ds.labels]
            fms, lms = [ds.features_mask], [ds.labels_mask]
        masks = {}
        if any(m is not None for m in fms):
            masks["fmask"] = [self._mask(m) for m in fms]
        if any(m is not None for m in lms):
            masks["lmask"] = [self._mask(m) for m in lms]
        return self._features(xs), self._labels(ys), masks

    def fit(self, data, labels=None, *, epochs: int = 1, batch_size: int = 32,
            steps_per_execution: int = 1):
        """Train (the JAX `fit`): `data` is an iterator of `DataSet`s, a
        `DataSet` (or a list of them), a `MultiDataSet` (one batch), an
        iterator or list of `MultiDataSet`s, or a feature array with
        `labels`, in order (JAX's graph does not shuffle).
        `steps_per_execution` groups minibatches (`nn/container.py`
        `_fit_iterator`)."""
        if isinstance(data, MultiDataSet):
            data = MultiDataSetIterator([data])
        elif (isinstance(data, (list, tuple)) and data
              and isinstance(data[0], MultiDataSet)):
            data = MultiDataSetIterator(list(data))
        if not isinstance(data, MultiDataSetIterator):
            data = as_iterator(data, labels, batch_size=batch_size)
        return self._fit_iterator(data, epochs, steps_per_execution)

    @torch.no_grad()
    def output(self, *inputs, masks=None):
        """The network outputs' activations in the output dtype (fp32):
        one tensor for a one-output graph, else a tuple."""
        xs = self._features(list(inputs))
        masks = None if masks is None else [self._mask(m) for m in masks]

        def fwd():
            acts = self._forward_all(xs, masks=masks)[0]
            return [acts[n] for n in self.conf.network_outputs]
        outs = [self.dtype.cast_output(o) for o in self._policy_call(fwd)]
        return outs[0] if len(outs) == 1 else tuple(outs)

    @torch.no_grad()
    def feed_forward(self, *inputs, masks=None) -> Dict[str, torch.Tensor]:
        """Every node's activation, the inputs' too (the JAX
        `feed_forward`: no dropout, in the compute dtype)."""
        xs = self._features(list(inputs))
        masks = None if masks is None else [self._mask(m) for m in masks]
        return self._policy_call(
            lambda: self._forward_all(xs, masks=masks)[0])

    @torch.no_grad()
    def score(self, dataset=None) -> float:
        """The loss (with the l1/l2 penalty, no dropout) on `dataset`
        (its masks are not applied, as in JAX), or the last fit
        minibatch's score without one."""
        if dataset is None:
            return self.score_value
        xs, ys = self._features(dataset.features), self._labels(
            dataset.labels)
        return float(self._policy_call(lambda: self._loss_fn(xs, ys),
                                       output_params=True))

    def _eval_output(self, features, features_mask, data_format=None):
        return self.output(features, masks=None if features_mask is None
                           else [features_mask])

    # ----------------------------------------------------- truncated BPTT
    def _tbptt_time(self, xs):
        if not self._is_tbptt():
            return None
        ts = [int(x.shape[1]) for x in xs if x.ndim == 3]
        return max(ts) if ts else None

    def _batch_of(self, xs) -> int:
        return int(xs[0].shape[0])

    def _chunk(self, xs, ys, fmasks, lmasks, s, L):
        """Rank-3 inputs and labels chunk along time; other inputs (a
        conv frame) pass whole."""
        def cut(a):
            return a if a is None or a.ndim != 3 else a[:, s:s + L]
        fm = None if fmasks is None else [
            None if m is None else m[:, s:s + L] for m in _as_list(fmasks)]
        lm = None if lmasks is None else [
            None if m is None else (m[:, s:s + L] if m.ndim >= 2 else m)
            for m in _as_list(lmasks)]
        return [cut(x) for x in xs], [cut(y) for y in ys], fm, lm

    # ------------------------------------------------------ rnn streaming
    def rnn_time_step(self, *inputs, masks=None):
        """Streaming inference carrying every recurrent node's state
        across calls (the JAX `rnn_time_step`): each input is [B, F] (one
        step) or [B, T, F], or [B, T] token ids where an embedding over
        a recurrent input takes it. A call with a one-step input returns
        outputs without their time axis. One tensor for a one-output
        graph, else a tuple, in the compute dtype."""
        xs = self._features(list(inputs))
        squeezed = [x.ndim == 2 and not self._ids_input(inp)
                    for inp, x in zip(self.conf.network_inputs, xs)]
        xs = [x[:, None, :] if sq else x for sq, x in zip(squeezed, xs)]
        t_new = max([1] + [int(x.shape[1]) for inp, x in
                           zip(self.conf.network_inputs, xs)
                           if x.ndim == 3 or (x.ndim == 2
                                              and self._ids_input(inp))])
        masks = None if masks is None else [self._mask(m) for m in masks]

        def fwd(carries):
            c = dict(carries)
            acts = self._forward_all(xs, masks=masks, carries=c)[0]
            return [acts[n] for n in self.conf.network_outputs], c
        outs = self._stream(fwd, int(xs[0].shape[0]), t_new)
        outs = [h[:, -1, :] if any(squeezed) and h.ndim == 3 else h
                for h in outs]
        return outs[0] if len(outs) == 1 else tuple(outs)

    def _ids_input(self, inp: str) -> bool:
        """Whether a layer taking network input `inp` reads token ids
        over a recurrent input (`time_series_input`)."""
        return any(getattr(n.layer, "time_series_input", False)
                   for n in self.conf.nodes.values()
                   if n.layer is not None and inp in n.inputs)

    # ----------------------------------------------------------- pretrain
    def _pretrain_targets(self):
        return [(n, self.conf.nodes[n].layer) for n in self.topo_order
                if self.conf.nodes[n].kind == "layer"
                and hasattr(self.conf.nodes[n].layer, "pretrain_loss")]

    @torch.no_grad()
    def _pretrain_features(self, key, features):
        """The input of node `key` from the walk of its ancestors only,
        in inference mode (the JAX `featurize`): the network inputs cast
        to the compute dtype, then computed against the fp32 params as
        JAX promotes them, and the node's own preprocessor last."""
        node = self.conf.nodes[key]
        target = node.inputs[0]
        ancestors, todo = set(), [target]
        while todo:
            n = todo.pop()
            if n not in ancestors:
                ancestors.add(n)
                todo.extend(self.conf.nodes[n].inputs)
        pd = self.dtype.param_dtype
        acts = {n: self.dtype.cast_compute(x).to(pd) for n, x in
                zip(self.conf.network_inputs, self._features(features))}
        for n in self.topo_order:
            sub = self.conf.nodes[n]
            if n not in ancestors or sub.kind == "input":
                continue
            ins = [acts[s] for s in sub.inputs]
            if sub.kind == "vertex":
                acts[n] = sub.vertex.forward(ins, masks=[None] * len(ins),
                                             train=False)
                continue
            h = ins[0]
            if sub.preprocessor is not None:
                h = sub.preprocessor.pre_process(h, None)
            acts[n] = self._call_layer(n, sub.layer, h, train=False,
                                       rng=None, mask=None, new_state=None)
        h = acts[target]
        if node.preprocessor is not None:
            h = node.preprocessor.pre_process(h, None)
        return h


def _as_list(m):
    if m is None:
        return None
    return list(m) if isinstance(m, (list, tuple)) else [m]
