"""The configuration serde and the ModelSerializer zip of the port against
the JAX package, on the CPU, with a small LM (vocab 64, d_model 64, 2
blocks, 2 heads of 32, ff x4, max_len 64).

- Configurations: the port's `to_dict()` equals the JAX package's for
  the same arguments, key for key, and each side's `from_json` reads the
  other's text back to an equal dict.
- JAX zip -> port and port zip -> JAX: params and updater state
  bit-equal (the arrays are copied, never recomputed); `output()` after
  a restore within atol 1e-5, greedy decoding token-equal, and one
  more step within the training tests' tolerances
  (tests/test_torch_port_training.py): loss rtol 1e-5, each param's
  relative Frobenius difference 1e-4, except the key bias `attn_bk`,
  whose gradient is zero up to rounding, held to twice Adam's step bound
  lr (1-b1)/sqrt(1-b2) per step (the other rules move it less).
- Corrupt, truncated, newer and ComputationGraph zips fail as JAX's
  restore fails; a failed write leaves the target as it was; every field
  the port does not train with is refused in `fit` and accepted by
  `output()`.
"""

import io
import json
import os
import zipfile
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.common.distributions as jd
import deeplearning4j_tpu.common.schedules as js
import deeplearning4j_tpu.common.updaters as ju
import deeplearning4j_tpu.nn.layers as jl
from deeplearning4j_tpu.fault.errors import (
    CheckpointCorruptError as JaxCorrupt,
)
from deeplearning4j_tpu.nn.conf.builder import (
    MultiLayerConfiguration as JaxConf,
    NeuralNetConfiguration as JaxNNC,
)
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.util.serializer import ModelSerializer as JaxZip
from deeplearning4j_tpu.zoo.transformer import (
    TransformerLM as JaxLM,
    generate as jax_generate,
)
import deeplearning4j_tpu_torch.common.distributions as pd
import deeplearning4j_tpu_torch.common.schedules as ps
import deeplearning4j_tpu_torch.common.updaters as pu
import deeplearning4j_tpu_torch.nn.conf.constraints as pcons
import deeplearning4j_tpu_torch.nn.conf.dropout as pdrop
import deeplearning4j_tpu_torch.nn.conf.weightnoise as pwn
import deeplearning4j_tpu_torch.nn.layers as pl
import deeplearning4j_tpu_torch.util.serializer as port_serializer
from deeplearning4j_tpu_torch.fault.errors import CheckpointCorruptError
from deeplearning4j_tpu_torch.nn.conf.builder import (
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    RnnToFeedForwardPreProcessor,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.jax_params import (
    from_jax_params,
    to_jax_params,
    to_jax_updater_state,
    to_numpy_params,
)
from deeplearning4j_tpu_torch.util.serializer import ModelSerializer
from deeplearning4j_tpu_torch.zoo.transformer import TransformerLM, generate

SMALL = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=2,
             ff_multiplier=4, max_len=64)
V, T = SMALL["vocab_size"], SMALL["max_len"] - 1
B = 4
OUTPUT_ATOL, LOSS_RTOL, PARAM_RTOL = 1e-5, 1e-5, 1e-4
ADAM_STEP_MAX = 1e-3 * 0.1 / np.sqrt(1e-3)
HEAD_SCALE = 8.0   # decisive greedy tokens (random heads give near ties)

J = SimpleNamespace(NNC=JaxNNC, InputType=JaxInputType, LM=JaxLM, u=ju,
                    s=js, d=jd, l=jl)
P = SimpleNamespace(NNC=NeuralNetConfiguration, InputType=InputType,
                    LM=TransformerLM, u=pu, s=ps, d=pd, l=pl)


def windows(seed, n):
    seq = np.random.default_rng(seed).integers(0, V, (n, T + 1))
    return (seq[:, :-1].astype(np.float32),
            np.eye(V, dtype=np.float32)[seq[:, 1:]])


# ---------------------------------------------------------- configurations
def lm_conf(S, *, policy=None, block=None, layer_updater=None, dist=False,
            dropout=None, sequence_parallel=None):
    """The zoo LM's chain through package S's builder, with options."""
    if not (policy or block or layer_updater or dist or dropout):
        return S.LM(**SMALL, sequence_parallel=sequence_parallel).conf()
    b = S.NNC.builder().seed(123).updater(S.u.Adam(1e-3))
    if dist:
        b.dist(S.d.NormalDistribution(0.0, 0.02))
    else:
        b.weight_init("xavier")
    if dropout is not None:
        b.dropout(dropout)
    if policy is not None:
        b.dtype_policy(policy)
    lb = (b.list().layer(S.l.EmbeddingLayer(n_in=V, n_out=SMALL["d_model"]))
          .layer(S.l.PositionalEncodingLayer(max_len=SMALL["max_len"])))
    for _ in range(SMALL["n_layers"]):
        lb.layer(S.l.TransformerEncoderBlock(
            n_heads=SMALL["n_heads"], ff_multiplier=4, causal=True,
            cache_len=SMALL["max_len"], **(block or {})))
    out = dict(updater=layer_updater(S)) if layer_updater else {}
    lb.layer(S.l.RnnOutputLayer(n_out=V, activation="softmax",
                                loss="mcxent", **out))
    lb.set_input_type(S.InputType.recurrent(V))
    return lb.build()


CONF_CASES = {
    "default": {},
    "ring": dict(sequence_parallel="ring"),
    "mixed_bf16": dict(policy="mixed_bf16"),
    "relu_bias_init": dict(block=dict(ff_activation="relu", bias_init=0.1)),
    "rmsprop_warmup_cosine": dict(layer_updater=lambda S: S.u.RmsProp(
        S.s.WarmupCosineSchedule(1e-3, 10, 100, 1e-5), 0.9, 1e-8)),
    "dist": dict(dist=True),
    "dropout": dict(dropout=0.9),
}


@pytest.mark.parametrize("case", list(CONF_CASES))
def test_lm_configuration_matches_jax_both_ways(case):
    jc, pc = lm_conf(J, **CONF_CASES[case]), lm_conf(P, **CONF_CASES[case])
    jd_, pd_ = jc.to_dict(), pc.to_dict()
    assert pd_ == jd_
    assert list(pd_) == list(jd_)
    assert [list(l) for l in pd_["layers"]] == [list(l) for l in
                                                jd_["layers"]]
    jt, pt = jc.to_json(indent=2), pc.to_json(indent=2)
    assert pt == jt
    assert MultiLayerConfiguration.from_json(jt).to_dict() == jd_
    assert JaxConf.from_json(pt).to_dict() == pd_


LAYER_CASES = [
    ("DenseLayer", dict(n_in=5, n_out=3, activation="tanh", bias_init=0.2,
                        l2=1e-4)),
    ("EmbeddingLayer", dict(n_in=11, n_out=4, has_bias=False)),
    ("PositionalEncodingLayer", dict(n_out=8, max_len=32)),
    ("TransformerEncoderBlock", dict(n_in=8, n_heads=2, causal=True,
                                     attention_dropout=0.9, remat=True,
                                     remat_policy="dots_saveable")),
    ("LayerNormalization", dict(n_out=8, eps=1e-6, name="ln")),
    ("MultiHeadAttention", dict(n_in=8, n_heads=2, causal=True,
                                use_flash=False)),
    ("RnnOutputLayer", dict(n_in=8, n_out=5, loss="mse",
                            activation="identity")),
]


@pytest.mark.parametrize("name,kw", LAYER_CASES, ids=[c[0] for c in
                                                      LAYER_CASES])
def test_layer_to_dict_matches_jax(name, kw):
    jlay, play = getattr(jl, name)(**kw), getattr(pl, name)(**kw)
    assert play.to_dict() == jlay.to_dict()
    assert list(play.to_dict()) == list(jlay.to_dict())
    assert jl.layer_from_dict(play.to_dict()).to_dict() == jlay.to_dict()
    assert pl.layer_from_dict(jlay.to_dict()).to_dict() == jlay.to_dict()


def test_newer_format_version_is_refused():
    d = lm_conf(J).to_dict()
    d["format_version"] = 2
    with pytest.raises(ValueError, match="newer"):
        MultiLayerConfiguration.from_dict(d)
    with pytest.raises(ValueError, match="newer"):
        JaxConf.from_dict(d)


def test_conf_builds_the_net_and_two_nets_never_share_params():
    conf = lm_conf(P)
    a = MultiLayerNetwork(conf, device="cpu").init(1)
    b = MultiLayerNetwork(conf, device="cpu").init(2)
    assert a.conf is conf and a.layers[0] is conf.layers[0]
    assert b.layers[0] is not a.layers[0]
    assert not torch.equal(a.layers[0].W, b.layers[0].W)
    assert b.conf.to_dict() == conf.to_dict()
    # a net from a layer list writes a configuration of its layers
    c = MultiLayerNetwork(P.LM(**SMALL).layers(), device="cpu")
    assert c.conf.to_dict()["layers"] == conf.to_dict()["layers"]


# ------------------------------------------------- the block's repairs
def test_block_ff_activation_and_bias_init_match_jax():
    """The port's block honours `ff_activation` (it ran gelu whatever the
    configuration said), and `bias_init` fills the biases JAX fills."""
    import jax
    import jax.numpy as jnp
    jb = jl.TransformerEncoderBlock(n_in=16, n_heads=2, causal=True,
                                    ff_activation="relu", bias_init=0.1)
    params = jb.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params = {k: jnp.asarray(np.asarray(v) + 0.1 * rng.standard_normal(
        v.shape).astype(np.float32)) for k, v in params.items()}
    x = rng.standard_normal((2, 7, 16)).astype(np.float32)
    want, _ = jb.forward(params, {}, jnp.asarray(x))
    pb = pl.layer_from_dict(jb.to_dict())
    assert pb.ff_activation == "relu"
    pb.load_jax_params({k: np.asarray(v) for k, v in params.items()})
    got = pb(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    gelu = pl.layer_from_dict(dict(jb.to_dict(), ff_activation="gelu"))
    gelu.load_jax_params({k: np.asarray(v) for k, v in params.items()})
    assert np.abs(gelu(torch.from_numpy(x)).numpy()
                  - np.asarray(want)).max() > 1e-2
    # bias_init: Dense and Embedding fill b with it, the block none
    gen = torch.Generator().manual_seed(0)
    for name in ("DenseLayer", "EmbeddingLayer"):
        jp = getattr(jl, name)(n_in=3, n_out=4, bias_init=0.1).init_params(
            jax.random.PRNGKey(0))
        play = getattr(pl, name)(n_in=3, n_out=4, bias_init=0.1)
        play.init_weights(gen)
        np.testing.assert_array_equal(play.b.numpy(), np.asarray(jp["b"]))
    fresh = pl.layer_from_dict(jb.to_dict())
    fresh.init_weights(gen)
    jfresh = jb.init_params(jax.random.PRNGKey(0))
    for k in ("ff_b1", "ff_b2", "attn_bq", "attn_bo", "ln1_beta"):
        np.testing.assert_array_equal(fresh.jax_param_map()[k].numpy(),
                                      np.asarray(jfresh[k]))


# ----------------------------------------------------------- JAX zip -> port
RULES = {
    "adam": lambda u: u.Adam(1e-3),
    "nesterovs": lambda u: u.Nesterovs(1e-3, 0.9),
    "adadelta": lambda u: u.AdaDelta(),
    "sgd": lambda u: u.Sgd(1e-2),
}


def jax_trained(rule, steps):
    conf = JaxLM(**SMALL, seed=5).conf()
    for layer in conf.layers:
        layer.updater = RULES[rule](ju)
    net = JaxNet(conf).init(5)
    head = str(len(net.layers) - 1)
    net.params[head]["W"] = net.params[head]["W"] * HEAD_SCALE
    x, y = windows(1, steps * B)
    net.fit(x, y, epochs=1, batch_size=B, shuffle=False)
    return net


def assert_tree_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            assert_tree_equal(got[k], want[k])
        else:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def assert_params_close(net, jparams, steps):
    got = to_jax_params(net)
    for lk, lp in jparams.items():
        for name, want in lp.items():
            diff = got[lk][name] - np.asarray(want)
            if name == "attn_bk":
                assert np.abs(diff).max() <= 2 * steps * ADAM_STEP_MAX
                continue
            rel = np.linalg.norm(diff) / np.linalg.norm(np.asarray(want))
            assert rel <= PARAM_RTOL, (lk, name, rel)


@pytest.mark.parametrize("rule", list(RULES))
def test_jax_zip_restores_in_the_port_and_resumes(rule, tmp_path):
    jnet = jax_trained(rule, 3)
    path = tmp_path / "jax.zip"
    JaxZip.write_model(jnet, path)
    net = ModelSerializer.restore_model(path, device="cpu")
    assert net.conf.to_dict() == jnet.conf.to_dict()
    assert_tree_equal(to_jax_params(net), jnet.params)
    assert_tree_equal(to_jax_updater_state(net), jnet.updater_state)
    assert (net.iteration_count, net.epoch_count) == (3, 1)
    assert (jnet.iteration_count, jnet.epoch_count) == (3, 1)
    ids = np.random.default_rng(2).integers(0, V, (2, 20))
    np.testing.assert_allclose(net.output(ids).numpy(),
                               np.asarray(jnet.output(ids)),
                               atol=OUTPUT_ATOL)
    np.testing.assert_array_equal(
        generate(net, ids[:, :6], 8, temperature=0),
        np.asarray(jax_generate(jnet, ids[:, :6], 8, temperature=0)))
    x, y = windows(3, B)
    jnet.fit(x, y, epochs=1, batch_size=B, shuffle=False)
    net.fit(x, y, epochs=1, batch_size=B, shuffle=False)
    assert abs(net.score_value - jnet.score_value) <= (
        LOSS_RTOL * abs(jnet.score_value))
    assert_params_close(net, jnet.params, 4)


def test_port_zip_restores_in_jax(tmp_path):
    jnet = JaxLM(**SMALL, seed=5).init()
    net = from_jax_params(TransformerLM(**SMALL).init(device="cpu"),
                          to_numpy_params(jnet.params))
    x, y = windows(4, 2 * B)
    net.fit(x, y, epochs=1, batch_size=B, shuffle=False)
    path = tmp_path / "port.zip"
    ModelSerializer.write_model(net, path)
    back = JaxZip.restore_model(path)         # verifies every crc
    assert back.conf.to_dict() == net.conf.to_dict()
    assert_tree_equal(back.params, to_jax_params(net))
    assert_tree_equal(back.updater_state, to_jax_updater_state(net))
    assert back.iteration_count == 2
    ids = np.random.default_rng(5).integers(0, V, (2, 20))
    np.testing.assert_allclose(np.asarray(back.output(ids)),
                               net.output(ids).numpy(), atol=OUTPUT_ATOL)


def test_save_updater_false_and_load_updater_false_leave_fresh_state(
        tmp_path):
    net = TransformerLM(**SMALL).init(device="cpu")
    x, y = windows(6, B)
    net.fit(x, y, epochs=1, batch_size=B, shuffle=False)
    ModelSerializer.write_model(net, tmp_path / "a.zip", save_updater=False)
    ModelSerializer.write_model(net, tmp_path / "b.zip")
    for back in (ModelSerializer.restore_model(tmp_path / "a.zip",
                                               device="cpu"),
                 ModelSerializer.restore_model(tmp_path / "b.zip",
                                               load_updater=False,
                                               device="cpu")):
        assert_tree_equal(to_jax_params(back), to_jax_params(net))
        assert back.iteration_count == 1
        for lstate in back.updater_state.values():
            for st in lstate.values():
                assert set(st) == {"m", "v"}
                assert all(not t.any() for t in st.values())
    with zipfile.ZipFile(tmp_path / "a.zip") as zf:
        assert "updater.npz" not in zf.namelist()


# ------------------------------------------------------------- failures
def _rewrite(src, dst, edit):
    """Copy the zip member by member, `edit(name, data)` -> new data."""
    with zipfile.ZipFile(src) as zi, zipfile.ZipFile(
            dst, "w", zipfile.ZIP_DEFLATED) as zo:
        for info in zi.infolist():
            zo.writestr(info.filename, edit(info.filename,
                                            zi.read(info.filename)))


def _npz_edit(data, fn):
    arrays = dict(np.load(io.BytesIO(data)))
    fn(arrays)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _flip_one_bit(arrays):
    """One bit of the first array's data: the npz and the zip around it
    stay well formed, so only meta.json's crc32 can see it."""
    a = arrays[sorted(arrays)[0]].copy()
    a.view(np.uint32).flat[3] ^= 1 << 4
    arrays[sorted(arrays)[0]] = a


def _corrupt(case, good, path):
    if case == "bit_flip_in_array":
        _rewrite(good, path, lambda n, d: d if n != "params.npz"
                 else _npz_edit(d, _flip_one_bit))
    elif case == "truncated":
        path.write_bytes(good.read_bytes()[: good.stat().st_size // 2])
    elif case == "corrupt_deflate":
        raw = bytearray(good.read_bytes())
        with zipfile.ZipFile(good) as zf:
            info = zf.getinfo("params.npz")
        start = info.header_offset + 30 + len(info.filename) + len(
            info.extra)
        for i in range(start + 200, start + 260):
            raw[i] ^= 0xA5
        path.write_bytes(bytes(raw))
    elif case == "format_version_2":
        _rewrite(good, path, lambda n, d: d if n != "configuration.json"
                 else json.dumps(dict(json.loads(d),
                                      format_version=2)).encode())
    elif case == "computation_graph":
        _rewrite(good, path, lambda n, d: d if n != "meta.json"
                 else json.dumps(dict(json.loads(d),
                                      model_type="ComputationGraph")).encode())


@pytest.mark.parametrize("case", ["bit_flip_in_array", "truncated",
                                  "corrupt_deflate", "format_version_2",
                                  "computation_graph"])
def test_bad_zips_fail_as_jax_fails(case, tmp_path):
    net = TransformerLM(**SMALL).init(device="cpu")
    good, bad = tmp_path / "good.zip", tmp_path / "bad.zip"
    ModelSerializer.write_model(net, good)
    _corrupt(case, good, bad)
    if case == "computation_graph":
        with pytest.raises(NotImplementedError, match="ComputationGraph"):
            ModelSerializer.restore_model(bad, device="cpu")
        return
    with pytest.raises(CheckpointCorruptError) as port_err:
        ModelSerializer.restore_model(bad, device="cpu")
    if case == "bit_flip_in_array":
        assert "checksum" in str(port_err.value)
    with pytest.raises(JaxCorrupt):
        JaxZip.restore_model(bad)
    if case == "format_version_2":
        assert isinstance(port_err.value.__cause__, ValueError)


def test_failed_write_leaves_the_target_and_no_tmp(tmp_path, monkeypatch):
    net = TransformerLM(**SMALL).init(device="cpu")
    path = tmp_path / "m.zip"
    ModelSerializer.write_model(net, path)
    before = path.read_bytes()

    def boom(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(port_serializer.np, "savez", boom)
    with pytest.raises(OSError, match="disk full"):
        ModelSerializer.write_model(net, path)
    assert path.read_bytes() == before
    assert sorted(os.listdir(tmp_path)) == ["m.zip"]


def test_restore_refuses_arrays_that_do_not_cover_the_configuration(
        tmp_path):
    net = TransformerLM(**SMALL).init(device="cpu")
    good = tmp_path / "good.zip"
    ModelSerializer.write_model(net, good)

    _rewrite(good, tmp_path / "slot.zip",
             lambda n, d: d if n != "updater.npz" else _npz_edit(
                 d, lambda arrays: arrays.pop("2::ff_W1__v")))
    with pytest.raises(KeyError, match="ff_W1"):
        ModelSerializer.restore_model(tmp_path / "slot.zip", device="cpu")
    conf = json.loads(zipfile.ZipFile(good).read("configuration.json"))
    conf["layers"][0]["n_in"] = V + 1           # the config decides n_in
    _rewrite(good, tmp_path / "shape.zip",
             lambda n, d: d if n != "configuration.json"
             else json.dumps(conf).encode())
    with pytest.raises(ValueError, match="0::W"):
        ModelSerializer.restore_model(tmp_path / "shape.zip", device="cpu")


# ------------------------------------------------------------- refusals
def _refuse(net, field):
    conf, blk, out = net.conf, net.layers[2], net.layers[-1]
    setters = {
        "dropout": lambda: setattr(out, "dropout", 0.9),
        "idropout": lambda: setattr(blk, "dropout", pdrop.Dropout(0.9)),
        "attention_dropout": lambda: setattr(blk, "attention_dropout", 0.9),
        "weight_noise": lambda: setattr(blk, "weight_noise",
                                        pwn.DropConnect(0.9)),
        "constraints": lambda: setattr(out, "constraints",
                                       [pcons.MaxNormConstraint(2.0)]),
        "l1": lambda: setattr(blk, "l1", 1e-4),
        "l2": lambda: setattr(out, "l2", 1e-4),
        "l1_bias": lambda: setattr(blk, "l1_bias", 1e-4),
        "l2_bias": lambda: setattr(blk, "l2_bias", 1e-4),
        "max_norm": lambda: setattr(conf, "max_norm", 1.0),
        "gradient_normalization": lambda: setattr(
            conf, "gradient_normalization", "clip_l2_per_layer"),
        "backprop_type": lambda: setattr(conf, "backprop_type", "tbptt"),
        "pretrain": lambda: setattr(conf, "pretrain", True),
        "optimization_algo": lambda: setattr(conf, "optimization_algo",
                                             "lbfgs"),
        "diagnostics": lambda: setattr(conf, "diagnostics",
                                       {"watchdog": "warn"}),
    }
    setters[field]()


REFUSED = ["dropout", "idropout", "attention_dropout", "weight_noise",
           "constraints", "l1", "l2", "l1_bias", "l2_bias", "max_norm",
           "gradient_normalization", "backprop_type", "pretrain",
           "optimization_algo", "diagnostics"]


@pytest.mark.parametrize("field", REFUSED)
def test_unported_fields_refused_in_fit_accepted_by_output(field):
    ref = TransformerLM(**SMALL).init(device="cpu")
    net = TransformerLM(**SMALL).init(device="cpu")
    _refuse(net, field)
    ids = np.random.default_rng(8).integers(0, V, (2, 12))
    assert torch.equal(net.output(ids), ref.output(ids))
    x, y = windows(9, B)
    with pytest.raises(NotImplementedError, match="not ported"):
        net.fit(x, y, batch_size=B)
    assert net.iteration_count == 0


def test_inert_fields_train_and_preprocessors_refuse_their_forward():
    conf = lm_conf(P)
    conf.scan_layers, conf.gradient_sharing = False, "threshold"
    for layer in conf.layers[2:4]:
        layer.remat, layer.remat_policy = True, "full"
    net = MultiLayerNetwork(conf, device="cpu").init(1)
    ref = TransformerLM(**SMALL).init(1, device="cpu")
    x, y = windows(10, B)
    net.fit(x, y, batch_size=B, shuffle=False)
    ref.fit(x, y, batch_size=B, shuffle=False)
    assert net.score_value == ref.score_value
    conf = lm_conf(P)
    conf.input_preprocessors[2] = RnnToFeedForwardPreProcessor()
    net = MultiLayerNetwork(conf, device="cpu")
    assert MultiLayerConfiguration.from_json(conf.to_json()).to_dict() == \
        conf.to_dict() == JaxConf.from_json(conf.to_json()).to_dict()
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        net.output(np.zeros((1, 4), np.int64))
