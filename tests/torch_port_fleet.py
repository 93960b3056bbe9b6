"""Shared pieces of the port's fleet tests (`test_torch_port_registry`,
`_fleet`, `_router`, `_replica`, `_routes`): twin LMs built from one
JAX init, twin MLPs, a gate on a replica's decode steps, and the wait
for a replica set to reach a size.

Twin LMs: the JAX zoo TransformerLM at its seed, the output head's W
scaled by `HEAD_SCALE` in the arrays given to both packages (greedy
logits are then decisive, not float-noise ties), carried into the
port's TransformerLM on the CPU by `util/jax_params.py`.
"""

from __future__ import annotations

import threading
import time

import numpy as np

HEAD_SCALE = 8.0


def twin_lm(seed, *, vocab, d_model, n_layers, n_heads, max_len):
    """(JAX net, port net on the CPU) with equal params."""
    from deeplearning4j_tpu.zoo.transformer import TransformerLM as JaxLM
    from deeplearning4j_tpu_torch.util.jax_params import (
        from_jax_params, to_numpy_params)
    from deeplearning4j_tpu_torch.zoo.transformer import TransformerLM
    jnet = JaxLM(vocab_size=vocab, d_model=d_model, n_layers=n_layers,
                 n_heads=n_heads, max_len=max_len, seed=seed).init()
    out = str(len(jnet.layers) - 1)
    jnet.params = {**jnet.params,
                   out: {**jnet.params[out],
                         "W": jnet.params[out]["W"] * HEAD_SCALE}}
    net = TransformerLM(vocab, d_model=d_model, n_layers=n_layers,
                        n_heads=n_heads, max_len=max_len).init(device="cpu")
    return jnet, from_jax_params(net, to_numpy_params(jnet.params))


def greedy_refs(jnet, net, prompts, n_tok):
    """JAX `generate()`'s greedy streams, asserted equal to the port's
    own `generate()` of the twin (the single-server reference both
    packages agree on)."""
    from deeplearning4j_tpu.zoo.transformer import generate as jax_generate
    from deeplearning4j_tpu_torch.zoo.transformer import generate
    want = np.asarray(jax_generate(jnet, np.asarray(prompts), n_tok,
                                   temperature=0))
    np.testing.assert_array_equal(
        generate(net, np.asarray(prompts), n_tok, temperature=0), want)
    return want


def jax_mlp(seed=7):
    from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork
    conf = (NeuralNetConfiguration.builder().seed(seed).list()
            .layer(DenseLayer(n_in=4, n_out=8, activation="tanh"))
            .layer(OutputLayer(n_in=8, n_out=3, activation="softmax",
                               loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf).init()


def port_mlp(seed=7):
    """The port's Dense(4 -> 8, tanh) -> Output(8 -> 3, softmax) on the
    CPU (the JAX registry tests' `tiny_mlp`)."""
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = (NeuralNetConfiguration.builder().seed(seed).list()
            .layer(DenseLayer(n_in=4, n_out=8, activation="tanh"))
            .layer(OutputLayer(n_in=8, n_out=3, activation="softmax",
                               loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


def params_equal(a, b) -> bool:
    """Two port nets' params bit for bit."""
    pa = {k: v.detach().cpu() for k, v in a.named_parameters()}
    pb = {k: v.detach().cpu() for k, v in b.named_parameters()}
    return pa.keys() == pb.keys() and all(
        bool((pa[k] == pb[k]).all()) for k in pa)


def gate_decode(server, opens_when=None) -> threading.Event:
    """Hold `server`'s decode steps until the returned event is set or
    `opens_when()` turns true: admission still emits each stream's first
    token, so a client sees a first chunk and then nothing until the
    gate opens, and the scheduler, held inside its step, takes nothing
    more from its submit queue. `gate.blocked` is set once a step is
    held. A kill gated on the first chunk finds every stream in flight,
    whatever the machine's speed."""
    gate = threading.Event()
    gate.blocked = threading.Event()
    eng = server.engine
    step = eng.step

    def held(*a, **k):
        while not gate.is_set() and not (opens_when and opens_when()):
            gate.blocked.set()
            gate.wait(0.002)
        return step(*a, **k)

    eng.step = held
    return gate


def gate_worker(worker) -> threading.Event:
    """`gate_decode` on a ReplicaWorker's server, opening when the worker
    stops (its relay has exited by then, so nothing decoded after the
    stop reaches a client)."""
    return gate_decode(worker.server, lambda: not worker._running)


def wait_first_chunk(streams, timeout=30.0):
    """Block until one of `streams` holds a token (the first reply
    chunk arrived); raise at the deadline."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if any(len(s.tokens) for s in streams):
            return
        time.sleep(0.001)
    raise AssertionError("no reply chunk arrived")


def wait_replicas(rset, n, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        rset.refresh(force=True)
        if len(rset.backends()) == n:
            return
        time.sleep(0.05)
    raise AssertionError(
        f"replica set never reached {n} backends "
        f"({len(rset.backends())} live)")
