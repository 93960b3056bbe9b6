"""Padding masks in the port against the JAX package, on the CPU: the
key padding mask of attention's plain path (a query row whose keys are
all masked is NaN on both sides, as JAX's -inf softmax gives it), the
masked losses, masked global pooling, `output(mask=)`,
`feed_forward(mask=)`, `score()` and `fit` with features and label masks
from a `DataSet` or an iterator (the label mask defaults to the mask the
layers carried), and the refusals that stay (streaming with a mask).

Tolerances: forward values within 1e-5 (atol and rtol: XLA:CPU and
PyTorch sum in another order). `fit`: the loss per step within rtol
1e-5; params (and Adam's m and v) by relative Frobenius difference,
within 1e-5 under SGD and 1e-4 under Adam (the training tests'
PARAM_RTOL): under a label mask Adam's m/sqrt(v) turns the rounding of
a near-zero gradient into a fraction of a step (measured 2.3e-5 on
block 3's attn_Wq, where the same run under SGD agrees within 1.8e-6).
`attn_bk` is held to Adam's step bound (its gradient is zero up to
rounding; see `tests/test_torch_port_training.py`).
"""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.common.activations import (
    get_activation as jax_activation,
)
from deeplearning4j_tpu.common.losses import get_loss as jax_loss
from deeplearning4j_tpu.common.updaters import Sgd as JaxSgd
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.datasets.iterator import (
    ArrayDataSetIterator as JaxIterator,
)
from deeplearning4j_tpu.nn.conf.builder import (
    MultiLayerConfiguration as JaxConf,
)
from deeplearning4j_tpu.nn.layers import MultiHeadAttention as JaxMHA
from deeplearning4j_tpu.nn.layers.pooling import (
    GlobalPoolingLayer as JaxPool,
)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.optimize.listeners import TrainingListener
from deeplearning4j_tpu.zoo.transformer import TransformerLM as JaxLM
from deeplearning4j_tpu_torch.common.activations import get_activation
from deeplearning4j_tpu_torch.common.losses import get_loss
from deeplearning4j_tpu_torch.datasets import (
    ArrayDataSetIterator,
    DataSet,
)
from deeplearning4j_tpu_torch.nn.conf.builder import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import (
    GlobalPoolingLayer,
    MultiHeadAttention,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import (
    MeshSpec,
    make_mesh,
    sequence_sharding,
)
from deeplearning4j_tpu_torch.util.jax_params import (
    from_jax_params,
    to_jax_params,
    to_jax_updater_state,
    to_numpy_params,
)

V, D, LAYERS, HEADS, MAXLEN, T, B = 64, 32, 2, 2, 32, 16, 2
ATOL = 1e-5
LOSS_RTOL = 1e-5
STATE_RTOL = {"sgd": 1e-5, "adam": 1e-4}
ADAM_STEP_MAX = 1e-3 * 0.1 / np.sqrt(1e-3)


def lengths_mask(lengths, T=T):
    return (np.arange(T)[None, :] < np.asarray(lengths)[:, None]).astype(
        np.float32)


def corpus(seed, n):
    seq = np.random.default_rng(seed).integers(0, V, (n, T + 1))
    return (seq[:, :-1].astype(np.float32),
            np.eye(V, dtype=np.float32)[seq[:, 1:]])


def lm_pair(causal=True, edit=None):
    """The tiny JAX LM (blocks `causal` or not) and the port net built
    from its configuration JSON with its params."""
    conf = JaxLM(vocab_size=V, d_model=D, n_layers=LAYERS, n_heads=HEADS,
                 max_len=MAXLEN, seed=5).conf()
    for layer in conf.layers[2:2 + LAYERS]:
        layer.causal = causal
    if edit is not None:
        edit(conf)
    conf = JaxConf.from_json(conf.to_json())
    jnet = JaxNet(conf).init(5)
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json()), device="cpu")
    return jnet, from_jax_params(net, to_numpy_params(jnet.params))


# --------------------------------------------------------------- attention
def _mha_pair(causal):
    jl = JaxMHA(n_in=D, n_out=D, n_heads=HEADS, causal=causal,
                use_flash=False)
    params = {k: np.asarray(v) for k, v in
              jl.init_params(__import__("jax").random.PRNGKey(3)).items()}
    rng = np.random.default_rng(1)
    params = {k: (v + rng.standard_normal(v.shape) * 0.1).astype(np.float32)
              for k, v in params.items()}
    pl = MultiHeadAttention(D, HEADS, causal=causal)
    pl.load_jax_params(params)
    return jl, params, pl


@pytest.mark.parametrize("causal", [False, True])
def test_attention_key_padding_mask_matches_jax(causal):
    jl, params, pl = _mha_pair(causal)
    x = np.random.default_rng(2).standard_normal((3, T, D)).astype(
        np.float32)
    mask = lengths_mask([T, 9, 1])
    want, _ = jl.forward({k: jnp.asarray(v) for k, v in params.items()}, {},
                         jnp.asarray(x), mask=jnp.asarray(mask))
    got = pl(torch.from_numpy(x), mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=ATOL)
    # unmasked, the plain path and flash attention agree with JAX too
    want0, _ = jl.forward({k: jnp.asarray(v) for k, v in params.items()},
                          {}, jnp.asarray(x))
    np.testing.assert_allclose(pl(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(want0), atol=ATOL, rtol=ATOL)


def test_a_fully_masked_row_is_nan_as_in_jax():
    """Every key of the row masked: the -inf softmax is NaN in JAX's
    plain path and in the port's, at the same places (ROADMAP hazard
    "Mask values")."""
    jl, params, pl = _mha_pair(False)
    x = np.random.default_rng(4).standard_normal((2, T, D)).astype(
        np.float32)
    mask = lengths_mask([5, 0])
    want, _ = jl.forward({k: jnp.asarray(v) for k, v in params.items()}, {},
                         jnp.asarray(x), mask=jnp.asarray(mask))
    got = pl(torch.from_numpy(x), mask=torch.from_numpy(mask)).numpy()
    want = np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[1]).all() and not np.isnan(got[0]).any()
    np.testing.assert_allclose(got[0], want[0], atol=ATOL, rtol=ATOL)


# ------------------------------------------------------- losses, pooling
@pytest.mark.parametrize("loss", ["mcxent", "mse", "xent", "l1"])
@pytest.mark.parametrize("rank", [2, 3])
def test_masked_losses_match_jax(loss, rank):
    rng = np.random.default_rng(5)
    shape = (4, 6, 7) if rank == 3 else (4, 7)
    pre = rng.standard_normal(shape).astype(np.float32)
    lab = rng.random(shape).astype(np.float32)
    mask = (rng.random(shape[:-1]) > 0.3).astype(np.float32)
    act = "softmax" if loss == "mcxent" else "sigmoid"
    want = jax_loss(loss)(jnp.asarray(lab), jnp.asarray(pre),
                          jax_activation(act), mask=jnp.asarray(mask))
    got = get_loss(loss)(torch.from_numpy(lab), torch.from_numpy(pre),
                         get_activation(act), mask=torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("pooling", ["max", "avg", "sum", "pnorm"])
@pytest.mark.parametrize("masked", [False, True])
def test_global_pooling_matches_jax(pooling, masked):
    x = np.random.default_rng(6).standard_normal((3, T, 5)).astype(
        np.float32)
    mask = lengths_mask([T, 7, 1]) if masked else None
    jp, pp = (JaxPool(pooling_type=pooling, pnorm=3),
              GlobalPoolingLayer(pooling_type=pooling, pnorm=3))
    want, _ = jp.forward({}, {}, jnp.asarray(x),
                         mask=None if mask is None else jnp.asarray(mask))
    got = pp(torch.from_numpy(x),
             mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)
    assert pp.forward_mask(mask) is None
    assert pp.to_dict() == jp.to_dict()


def test_global_pooling_refuses_cnn_inputs():
    """The refusal of NHWC input is lifted: it pools over (H, W) as JAX
    does, every pooling type; other ranks are still refused."""
    x = np.random.default_rng(7).standard_normal((2, 3, 4, 5)).astype(
        np.float32)
    for pooling in ("max", "avg", "sum", "pnorm"):
        jp, pp = (JaxPool(pooling_type=pooling, pnorm=3),
                  GlobalPoolingLayer(pooling_type=pooling, pnorm=3))
        want, _ = jp.forward({}, {}, jnp.asarray(x))
        np.testing.assert_allclose(pp(torch.from_numpy(x)).numpy(),
                                   np.asarray(want), atol=ATOL, rtol=ATOL)
    with pytest.raises(ValueError, match="3d or 4d"):
        GlobalPoolingLayer()(torch.zeros(1, 2, 2, 3, 1))


# ------------------------------------------------------------ container
@pytest.mark.parametrize("causal", [True, False])
def test_output_and_feed_forward_with_a_mask_match_jax(causal):
    jnet, net = lm_pair(causal)
    x, _ = corpus(1, 3)
    mask = lengths_mask([T, 10, 4])
    want = np.asarray(jnet.output(x, mask=jnp.asarray(mask)))
    got = net.output(x, mask=mask).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    # the mask changes the real positions' outputs only where it should:
    # the causal LM's row 1 is unchanged before its padding begins
    plain = net.output(x).numpy()
    if causal:
        np.testing.assert_allclose(got[1, :10], plain[1, :10], atol=ATOL)
    acts = net.feed_forward(x, mask=mask)
    jacts = jnet.feed_forward(x, mask=jnp.asarray(mask))
    assert len(acts) == len(jacts) == len(net.layers)
    for a, j in zip(acts, jacts):
        np.testing.assert_allclose(a.numpy(), np.asarray(j), atol=ATOL,
                                   rtol=ATOL)


def test_score_with_masks_matches_jax():
    jnet, net = lm_pair()
    x, y = corpus(2, 3)
    fm, lm = lengths_mask([T, 9, 3]), lengths_mask([T, 6, 3])
    for kw in ({}, {"features_mask": fm}, {"labels_mask": lm},
               {"features_mask": fm, "labels_mask": lm}):
        want = jnet.score(JaxDataSet(x, y, **kw))
        got = net.score(DataSet(x, y, **kw))
        np.testing.assert_allclose(got, want, rtol=1e-6)


class _Scores(TrainingListener):
    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration, epoch, score, **info):
        self.scores.append(score)


def _assert_same_training(jnet, jl, net, pl, rtol):
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    got, ust = to_jax_params(net), to_jax_updater_state(net)
    for lk, lp in to_numpy_params(jnet.params).items():
        for name, w in lp.items():
            diff = got[lk][name] - w
            if name == "attn_bk":
                assert np.abs(diff).max() <= 2 * len(pl) * ADAM_STEP_MAX
                continue
            assert np.linalg.norm(diff) <= rtol * np.linalg.norm(w), (
                lk, name)
            for sk, ws in jnet.updater_state[lk][name].items():
                ws = np.asarray(ws)
                assert (np.linalg.norm(ust[lk][name][sk] - ws)
                        <= rtol * max(np.linalg.norm(ws), 1e-30))


MASKINGS = {
    "features": lambda n: dict(features_mask=lengths_mask(
        np.random.default_rng(n).integers(1, T + 1, n))),
    "labels": lambda n: dict(labels_mask=lengths_mask(
        np.random.default_rng(n + 1).integers(1, T + 1, n))),
    "both": lambda n: dict(
        features_mask=lengths_mask(
            np.random.default_rng(n).integers(4, T + 1, n)),
        labels_mask=lengths_mask(
            np.random.default_rng(n + 1).integers(1, T + 1, n))),
}


def _edit_for(updater):
    def edit(conf):
        conf.layers[2].dropout = 0.9
        if updater == "sgd":
            for layer in conf.layers:
                if hasattr(layer, "updater"):
                    layer.updater = JaxSgd(0.1)
    return edit


@pytest.mark.parametrize("updater", ["adam", "sgd"])
@pytest.mark.parametrize("masking", sorted(MASKINGS))
@pytest.mark.parametrize("source", ["dataset", "iterator"])
def test_fit_with_masks_matches_jax(masking, source, updater):
    """Three steps on padded windows. Without a label mask the loss
    takes the features mask the layers carried (JAX `_loss_fn`)."""
    jnet, net = lm_pair(edit=_edit_for(updater))
    n = 3 * B
    x, y = corpus(3, n)
    masks = MASKINGS[masking](n)
    rec, mine = _Scores(), _Scores()
    jnet.set_listeners(rec)
    net.set_listeners(mine)
    if source == "dataset":
        jnet.fit(JaxDataSet(x, y, **masks), batch_size=B)
        net.fit(DataSet(x, y, **masks), batch_size=B)
    else:
        jnet.fit(JaxIterator(x, y, batch_size=B, shuffle=True, **masks))
        net.fit(ArrayDataSetIterator(x, y, batch_size=B, shuffle=True,
                                     **masks))
    assert len(mine.scores) == len(rec.scores) == 3
    _assert_same_training(jnet, rec.scores, net, mine.scores,
                          STATE_RTOL[updater])


def test_the_mask_changes_training():
    jnet, net = lm_pair()
    x, y = corpus(3, 2 * B)
    masks = MASKINGS["both"](2 * B)
    plain = MultiLayerNetwork(net.conf, device="cpu")
    plain.load_state_dict(net.state_dict())
    net.fit(DataSet(x, y, **masks), batch_size=B)
    plain.fit(DataSet(x, y), batch_size=B)
    assert net.score_value != plain.score_value


def test_streaming_with_a_mask_is_refused():
    _, net = lm_pair()
    block = net.layers[2]
    carry = block.init_carry(1, torch.float32, net.device)
    with pytest.raises(ValueError, match="padding mask"):
        block.forward_with_carry(torch.zeros(1, 2, D), carry,
                                 mask=torch.ones(1, 2))


@pytest.mark.parametrize("sp", ["ring", "ulysses"])
def test_sequence_parallel_layers_take_the_masked_local_path(sp, caplog):
    """Inside `sequence_sharding`, a padding mask keeps a ring/Ulysses
    layer on the local masked path (the ring and Ulysses schedules are
    mask-free, as in JAX), with a one-time notice."""
    jnet, net = lm_pair(edit=lambda c: [setattr(l, "sequence_parallel", sp)
                                        for l in c.layers[2:2 + LAYERS]])
    x, _ = corpus(4, 2)
    mask = lengths_mask([T, 8])
    mesh = make_mesh(MeshSpec.of(seq=2), devices=["cpu"] * 2)
    with sequence_sharding(mesh):
        got = net.output(x, mask=mask).numpy()
    want = np.asarray(jnet.output(x, mask=jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
