"""The port's multi-tenant LoRA tier (`deeplearning4j_tpu_torch/tenancy/`,
the registry's adapter store) against the JAX package's
(`tests/test_tenancy.py`), on JAX's `tiny_lm` (vocab 12, d16, 1 layer)
and a 2-layer LM, the same seeded inputs through both packages.

Contracts and tolerances:
- `init_adapter` equals JAX's: B exactly, A within 2e-6 relative plus
  2.5e-7 (the last places of fp32 erfinv, which the two packages compute
  with different polynomials), folded by the SORTED key index and
  divided by rank.
- Frozen and unfrozen `fit` over 3 steps: losses and the factors within
  rtol 1e-5 of JAX's; a frozen base stays bit-identical (every leaf);
  an unfrozen base within 1e-4 relative Frobenius of JAX's, `attn_bk`
  by Adam's step bound (it trains on rounding noise).
- Stripping initialises the adapted weights' updater slots afresh.
- A zero adapter is the base function: greedy streams bit-equal with the
  adapter on or off, train-side (`attach_adapter`) and serve-side (a
  composed serving tree).
- Adapter zips cross packages both ways bit for bit; corruption is
  caught by the crc32; retention never collects a pinned adapter, a
  live process's marker included.
- The composed cache hits, and rebuilds on a base `params_version` bump
  and per adapter version; composed leaves share the base's tensors.
- An int8 base with an adapter: probabilities within 1e-5 of JAX's int8
  composition, greedy streams by margin (near-ties counted).
- A TenantFleet serves two tenants from one base copy, swaps one to its
  next adapter version under a gated decode and drops no stream.
Every wait is on an event (`tests/torch_port_fleet.py`), never a sleep.
"""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nd import quant as jquant
from deeplearning4j_tpu.nn.layers.recurrent import BaseRecurrentLayer
from deeplearning4j_tpu.serving import ModelRegistry as JaxRegistry
from deeplearning4j_tpu.tenancy import lora as jlora
from deeplearning4j_tpu.zoo.transformer import TransformerLM as JaxLM
from deeplearning4j_tpu.zoo.transformer import generate as jax_generate
from deeplearning4j_tpu_torch.nd import quant
from deeplearning4j_tpu_torch.serving import FleetRouter, ModelRegistry
from deeplearning4j_tpu_torch.tenancy import TenantFleet, lora
from deeplearning4j_tpu_torch.tenancy.fleet import _TenantNetView
from deeplearning4j_tpu_torch.util.jax_params import (
    from_jax_params,
    to_numpy_params,
)
from deeplearning4j_tpu_torch.zoo.transformer import (
    TransformerLM,
    generate,
    stream_agreement,
    teacher_forced_probs,
)
from torch_port_fleet import gate_decode, wait_first_chunk

INIT_ATOL, INIT_RTOL = 2.5e-7, 2e-6
FIT_RTOL = 1e-5
BASE_RTOL = 1e-4
PROB_ATOL = 1e-5


def jax_lm(seed=7, *, vocab=12, d=16, layers=1, heads=2, max_len=12,
           head_scale=1.0):
    jnet = JaxLM(vocab_size=vocab, d_model=d, n_layers=layers,
                 n_heads=heads, max_len=max_len, seed=seed).init()
    if head_scale != 1.0:
        out = str(len(jnet.layers) - 1)
        jnet.params = {**jnet.params,
                       out: {**jnet.params[out],
                             "W": jnet.params[out]["W"] * head_scale}}
    return jnet


def tiny_pair(seed=7, **kw):
    """(JAX tiny_lm, the port's twin on the CPU), equal params."""
    jnet = jax_lm(seed, **kw)
    a = dict(dict(vocab=12, d=16, layers=1, heads=2, max_len=12), **kw)
    a.pop("head_scale", None)
    net = TransformerLM(a["vocab"], d_model=a["d"], n_layers=a["layers"],
                        n_heads=a["heads"], max_len=a["max_len"]).init(
                            device="cpu")
    return jnet, from_jax_params(net, to_numpy_params(jnet.params))


def fit_data(seed, vocab=12, B=4, T=8):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, vocab, (B, T)).astype(np.float32)
    y = np.eye(vocab, dtype=np.float32)[rng.integers(0, vocab, (B, T))]
    return x, y


def fit_both(jnet, net, steps, seed):
    x, y = fit_data(seed, int(net.layers[-1].n_out))
    jl, pl = [], []
    for _ in range(steps):
        jnet.fit(x, y, epochs=1, batch_size=4, shuffle=False)
        jl.append(float(jnet.score_value))
        net.fit(x, y, epochs=1, batch_size=4, shuffle=False)
        pl.append(float(net.score_value))
    return jl, pl


def np_adapter(ad):
    return {lk: {pk: {s: np.asarray(t.detach().cpu() if isinstance(
        t, torch.Tensor) else t) for s, t in ba.items()}
        for pk, ba in lv.items()} for lk, lv in ad.items()}


def table(net):
    return {k: v.detach().cpu().clone() for k, v in net.param_table().items()}


def assert_adapters_close(got, want, rtol, atol=0.0):
    got, want = np_adapter(got), np_adapter(want)
    assert got.keys() == want.keys()
    for lk in want:
        assert got[lk].keys() == want[lk].keys()
        for pk in want[lk]:
            for s in "BA":
                g, w = got[lk][pk][s], want[lk][pk][s]
                scale = max(float(np.abs(w).max()), 1e-30)
                assert float(np.abs(g - w).max()) <= rtol * scale + atol, \
                    (lk, pk, s, float(np.abs(g - w).max()), scale)


def random_b(ad, seed, scale=0.5):
    """`ad` with seeded nonzero B factors (numpy), for tests where a zero
    delta would hide the composition."""
    rng = np.random.default_rng(seed)
    out = np_adapter(ad)
    for lv in out.values():
        for ba in lv.values():
            ba["B"] = (rng.standard_normal(ba["B"].shape) * scale).astype(
                np.float32)
    return out


def composed_view(net, adapter, rank, alpha, mode=None):
    def tree_of(_):
        return lora.compose_serving_tree(net, quant.serving_params(net, mode),
                                         adapter, rank=rank, alpha=alpha)
    return _TenantNetView(net, tree_of)


# ============================================================ adapter init
class TestAdapterInit:
    @pytest.mark.parametrize("rank,seed", [(1, 0), (2, 3), (4, 11)])
    def test_init_equals_jax(self, rank, seed):
        jnet, net = tiny_pair()
        ja = jlora.init_adapter(jnet, rank=rank, seed=seed)
        pa = lora.init_adapter(net, rank=rank, seed=seed)
        assert lora.adapter_weight_keys(net) == jlora.adapter_weight_keys(
            jnet)
        ja, pa = np_adapter(ja), np_adapter(pa)
        assert ja.keys() == pa.keys()
        for lk in ja:
            assert ja[lk].keys() == pa[lk].keys()
            for pk in ja[lk]:
                np.testing.assert_array_equal(pa[lk][pk]["B"],
                                              ja[lk][pk]["B"])
                assert pa[lk][pk]["A"].shape == ja[lk][pk]["A"].shape
                np.testing.assert_allclose(pa[lk][pk]["A"], ja[lk][pk]["A"],
                                           rtol=INIT_RTOL, atol=INIT_ATOL)

    def test_sorted_fold_order_and_divide_by_rank(self):
        from deeplearning4j_tpu_torch.common import prng
        _, net = tiny_pair()
        ad = lora.init_adapter(net, rank=4, seed=5)
        keys = lora.adapter_weight_keys(net)["2"]
        assert keys != sorted(keys)        # declared order is not sorted
        for j, pk in enumerate(sorted(keys)):
            k = prng.fold_in(prng.fold_in(prng.key(5), 2), j)
            n_out = ad["2"][pk]["A"].shape[1]
            want = prng.normal(k, (4, n_out)) / 4.0
            torch.testing.assert_close(ad["2"][pk]["A"], want, rtol=0,
                                       atol=0)

    def test_rank_checked_and_embedding_left_out(self):
        _, net = tiny_pair()
        with pytest.raises(ValueError, match="rank"):
            lora.init_adapter(net, rank=0)
        assert "0" not in lora.adapter_weight_keys(net)


# ============================================== frozen-base training
class TestAdapterTraining:
    @pytest.mark.parametrize("layers", [1, 2])
    def test_frozen_fit_matches_jax_and_keeps_base(self, layers):
        jnet, net = tiny_pair(layers=layers)
        fit_both(jnet, net, 1, seed=0)           # past the init step
        before = table(net)
        ja = jlora.init_adapter(jnet, rank=2, seed=5)
        pa = lora.init_adapter(net, rank=2, seed=5)
        jlora.attach_adapter(jnet, ja, rank=2, alpha=4.0, frozen=True)
        lora.attach_adapter(net, pa, rank=2, alpha=4.0, frozen=True)
        jl, pl = fit_both(jnet, net, 3, seed=1)
        np.testing.assert_allclose(pl, jl, rtol=FIT_RTOL)
        assert_adapters_close(lora.extract_adapter(net),
                              jlora.extract_adapter(jnet), FIT_RTOL, 1e-7)
        moved = any(float(ba["B"].abs().sum()) > 0
                    for lv in lora.extract_adapter(net).values()
                    for ba in lv.values())
        assert moved
        after = table(net)
        assert all(torch.equal(before[k], after[k]) for k in before)
        lora.strip_adapter(net)
        assert all(torch.equal(before[k], v) for k, v in table(net).items())

    def test_unfrozen_fit_moves_the_base_as_jax(self):
        jnet, net = tiny_pair()
        fit_both(jnet, net, 1, seed=0)
        before = table(net)
        for a, n in ((jlora, jnet), (lora, net)):
            a.attach_adapter(n, a.init_adapter(n, rank=1, seed=5), rank=1,
                             alpha=2.0, frozen=False)
        jl, pl = fit_both(jnet, net, 3, seed=1)
        np.testing.assert_allclose(pl, jl, rtol=FIT_RTOL)
        assert_adapters_close(lora.extract_adapter(net),
                              jlora.extract_adapter(jnet), FIT_RTOL, 1e-7)
        assert set(net.updater_state["2"]["attn_Wq"]) == {"B", "A", "base"}
        jlora.strip_adapter(jnet)
        lora.strip_adapter(net)
        got, want = table(net), to_numpy_params(jnet.params)
        assert any(not torch.equal(before[k], got[k]) for k in got)
        bound = 2 * 3 * 1e-3 * 0.1 / np.sqrt(1e-3)    # Adam's step bound
        for k, v in got.items():
            lk, pk = k.split("_", 1)
            w = want[lk][pk]
            if pk.endswith("attn_bk"):
                assert float(np.abs(v.numpy() - w).max()) <= bound, k
                continue
            rel = float(np.linalg.norm(v.numpy() - w)
                        / max(np.linalg.norm(w), 1e-30))
            assert rel <= BASE_RTOL, (k, rel)

    def test_strip_reinits_the_base_slots(self):
        jnet, net = tiny_pair()
        fit_both(jnet, net, 2, seed=0)
        moments = {k: float(v["m"].abs().sum())
                   for k, v in net.updater_state["2"].items()}
        assert moments["attn_Wq"] > 0
        for a, n in ((jlora, jnet), (lora, net)):
            a.attach_adapter(n, a.init_adapter(n, rank=2, seed=1), rank=2,
                             alpha=4.0)
        assert set(net.updater_state["2"]["attn_Wq"]) == {"B", "A"}
        fit_both(jnet, net, 2, seed=1)
        jlora.strip_adapter(jnet)
        lora.strip_adapter(net)
        for pk in lora.adapter_weight_keys(net)["2"]:
            st = net.updater_state["2"][pk]
            assert set(st) == {"m", "v"}
            assert float(st["m"].abs().sum()) == 0.0
            assert float(st["v"].abs().sum()) == 0.0
            np.testing.assert_array_equal(
                st["m"].numpy(), np.asarray(jnet.updater_state["2"][pk]["m"]))
        # a plain leaf beside the adapted ones kept its moments
        assert float(net.updater_state["2"]["attn_bq"]["m"].abs().sum()) > 0

    def test_fused_adam_takes_every_factor_in_one_call(self, monkeypatch):
        from deeplearning4j_tpu_torch.nn import container
        calls = []
        real = container.adam_update_packed

        def spy(updater, ps, *a, **k):
            calls.append(len(ps))
            return real(updater, ps, *a, **k)

        monkeypatch.setattr(container, "adam_update_packed", spy)
        _, net = tiny_pair(layers=2)
        lora.attach_adapter(net, lora.init_adapter(net, rank=2), rank=2,
                            alpha=4.0)
        x, y = fit_data(0)
        net.fit(x, y, epochs=1, batch_size=4, shuffle=False)
        # 2 blocks x 6 weights + the head = 13 adapted weights, B and A
        assert calls == [26]

    def test_sgd_factors_match_jax(self):
        """A non-Adam updater moves the factors per leaf
        (`lora.apply_adapter_update`), as JAX's branch does."""
        from deeplearning4j_tpu.common.updaters import Sgd as JSgd
        from deeplearning4j_tpu_torch.common.updaters import Sgd
        jnet, net = tiny_pair()
        for jl_, pl_ in zip(jnet.layers, net.layers):
            jl_.updater, pl_.updater = JSgd(0.1), Sgd(0.1)
        for a, n in ((jlora, jnet), (lora, net)):
            a.attach_adapter(n, a.init_adapter(n, rank=2, seed=2), rank=2,
                             alpha=4.0)
        jl, pl = fit_both(jnet, net, 3, seed=4)
        np.testing.assert_allclose(pl, jl, rtol=FIT_RTOL)
        assert_adapters_close(lora.extract_adapter(net),
                              jlora.extract_adapter(jnet), FIT_RTOL, 1e-7)
        assert net.updater_state["2"]["attn_Wq"] == {"B": {}, "A": {}}

    def test_copy_keeps_the_adapter_and_its_slots(self):
        _, net = tiny_pair()
        lora.attach_adapter(net, lora.init_adapter(net, rank=2, seed=2),
                            rank=2, alpha=4.0)
        x, y = fit_data(5)
        net.fit(x, y, epochs=1, batch_size=4, shuffle=False)
        clone = net.copy()
        assert lora.adapter_config(clone) == lora.adapter_config(net)
        torch.testing.assert_close(clone.output(x), net.output(x), rtol=0,
                                   atol=0)
        st, cst = (n.updater_state["3"]["W"]["B"]["m"] for n in (net, clone))
        assert torch.equal(st, cst) and st.data_ptr() != cst.data_ptr()
        clone.fit(x, y, epochs=1, batch_size=4, shuffle=False)
        net.fit(x, y, epochs=1, batch_size=4, shuffle=False)
        assert_adapters_close(lora.extract_adapter(clone),
                              lora.extract_adapter(net), 0.0)

    def test_online_resume_with_an_adapter_is_bit_equal(self, tmp_path):
        """A tenant's online run, checkpointed with its adapter and
        cursor, resumes in a net built from the checkpoint (the adapter
        attached again) bit-equal to the uninterrupted run."""
        from deeplearning4j_tpu_torch.online import (
            OnlineTrainer, StreamingDataSetIterator, lm_example)
        from deeplearning4j_tpu_torch.optimize.listeners import (
            CollectScoresListener)
        from deeplearning4j_tpu_torch.streaming import (
            LocalLogTransport, serialize_ndarray)
        rng = np.random.default_rng(8)
        records = [np.stack([rng.integers(0, 12, 8), rng.integers(0, 12, 8)])
                   for _ in range(6 * 2)]

        def stream():
            t = LocalLogTransport()
            for r in records:
                t.send("t", serialize_ndarray(r))
            return StreamingDataSetIterator(
                t, "t", batch_size=2, watermark_timeout_s=2.0,
                record_to_example=lambda r: lm_example(r, vocab_size=12))

        def adapted():
            _, n = tiny_pair()
            return lora.attach_adapter(
                n, lora.init_adapter(n, rank=2, seed=3), rank=2, alpha=4.0)

        ref, scores = adapted(), CollectScoresListener()
        OnlineTrainer(ref, stream(), listeners=[scores]).run(max_steps=6)
        OnlineTrainer(adapted(), stream(), checkpoint_dir=tmp_path,
                      checkpoint_frequency=3,
                      checkpoint_at_fit_end=False).run(max_steps=4)
        it = stream()
        tr = OnlineTrainer.resume(tmp_path, it, device="cpu")
        assert tr.net.iteration_count == 3 and it.cursor()["batch"] == 3
        assert lora.adapter_config(tr.net) == {"rank": 2, "alpha": 4.0,
                                               "frozen": True}
        got = CollectScoresListener()
        tr.extra_listeners.append(got)
        tr.run(max_steps=3)
        assert got.scores == scores.scores[3:]
        assert_adapters_close(lora.extract_adapter(tr.net),
                              lora.extract_adapter(ref), 0.0)
        assert all(torch.equal(a, b) for a, b in zip(
            table(tr.net).values(), table(ref).values()))

    def test_refusals(self):
        _, net = tiny_pair()
        ad = lora.init_adapter(net, rank=1)
        lora.attach_adapter(net, ad, rank=1, alpha=2.0)
        with pytest.raises(ValueError, match="already carries"):
            lora.attach_adapter(net, ad, rank=1, alpha=2.0)
        lora.strip_adapter(net)
        net.layers[2].l2 = 1e-4
        with pytest.raises(ValueError, match="l1/l2"):
            lora.attach_adapter(net, ad, rank=1, alpha=2.0)
        net.layers[2].l2 = 0.0
        bad = {"2": {"attn_Wq": {"B": np.zeros((3, 1), np.float32),
                                 "A": np.zeros((1, 16), np.float32)}}}
        with pytest.raises(ValueError, match="don't fit"):
            lora.attach_adapter(net, bad, rank=1, alpha=2.0)


# ===================================================== on/off parity
class TestAdapterParity:
    def test_zero_adapter_is_the_base_function(self):
        jnet, net = tiny_pair()
        fit_both(jnet, net, 1, seed=0)
        prompts = np.stack([np.arange(4) % 12, (np.arange(4) + 3) % 12])
        ref = generate(net, prompts, 6, temperature=0)
        np.testing.assert_array_equal(
            ref, np.asarray(jax_generate(jnet, prompts, 6, temperature=0)))
        ad = lora.init_adapter(net, rank=2, seed=9)
        lora.attach_adapter(net, ad, rank=2, alpha=4.0)
        on = generate(net, prompts, 6, temperature=0)
        lora.strip_adapter(net)
        np.testing.assert_array_equal(ref, on)
        served = generate(composed_view(net, ad, 2, 4.0), prompts, 6,
                          temperature=0)
        np.testing.assert_array_equal(ref, served)

    def test_trained_adapter_changes_the_function(self):
        _, net = tiny_pair()
        x, y = fit_data(0)
        net.fit(x, y, epochs=1, batch_size=4, shuffle=False)
        prompts = np.stack([np.arange(4) % 12]).astype(np.float32)
        ref = net.output(prompts)
        lora.attach_adapter(net, lora.init_adapter(net, rank=2, seed=9),
                            rank=2, alpha=4.0)
        x, y = fit_data(2)
        for _ in range(6):
            net.fit(x, y, epochs=1, batch_size=4, shuffle=False)
        on = net.output(prompts)
        trained = lora.strip_adapter(net)
        off = net.output(prompts)
        assert torch.equal(ref, off)
        assert not torch.equal(ref, on)
        # the serve-side composition of the trained adapter is the
        # train-side function
        view = composed_view(net, trained, 2, 4.0)
        p = np.arange(4) % 12
        t = generate(view, p[None], 5, temperature=0)[0]
        lora.attach_adapter(net, trained, rank=2, alpha=4.0)
        np.testing.assert_array_equal(
            teacher_forced_probs(view, p, t), teacher_forced_probs(net, p, t))

    def test_nonzero_adapter_composition_matches_jax(self):
        jnet, net = tiny_pair(layers=2, vocab=12, head_scale=8.0)
        ad = random_b(lora.init_adapter(net, rank=2, seed=4), seed=8)
        prompts = np.random.default_rng(3).integers(0, 12, (3, 4))
        jlora.attach_adapter(jnet, ad, rank=2, alpha=4.0)
        want = np.asarray(jax_generate(jnet, prompts, 6, temperature=0))
        lora.attach_adapter(net, ad, rank=2, alpha=4.0)
        np.testing.assert_array_equal(
            generate(net, prompts, 6, temperature=0), want)


# ============================================================ serde
class TestAdapterSerde:
    def test_file_round_trip_bit_exact(self, tmp_path):
        _, net = tiny_pair()
        ad = lora.init_adapter(net, rank=2, seed=3)
        p = tmp_path / "adapter.zip"
        lora.save_adapter(p, ad, meta={"rank": 2, "alpha": 4.0})
        back, meta = lora.load_adapter(p)
        assert meta["rank"] == 2 and meta["alpha"] == 4.0
        for lk, lv in ad.items():
            for pk, ba in lv.items():
                for s in "BA":
                    assert torch.equal(back[lk][pk][s], ba[s])

    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_zips_cross_packages(self, tmp_path, writer):
        jnet, net = tiny_pair()
        ad = random_b(lora.init_adapter(net, rank=2, seed=3), seed=1)
        p = tmp_path / "adapter.zip"
        if writer == "port":
            lora.save_adapter(p, ad, meta={"rank": 2, "alpha": 4.0})
            back, meta = jlora.load_adapter(p)
        else:
            jlora.save_adapter(p, ad, meta={"rank": 2, "alpha": 4.0})
            back, meta = lora.load_adapter(p)
        assert meta["rank"] == 2
        back = np_adapter(back)
        for lk, lv in ad.items():
            for pk, ba in lv.items():
                for s in "BA":
                    assert back[lk][pk][s].tobytes() == ba[s].tobytes()

    def test_registry_roots_cross_packages(self, tmp_path):
        jnet, net = tiny_pair()
        ad = random_b(lora.init_adapter(net, rank=1, seed=1), seed=2)
        preg, jreg = ModelRegistry(tmp_path), JaxRegistry(str(tmp_path))
        base_v = preg.publish("m", net)
        v1 = preg.publish_adapter("m", "acme", ad, base_version=base_v,
                                  rank=1, alpha=2.0)
        v2 = jreg.publish_adapter("m", "beta", ad, base_version=base_v,
                                  rank=1, alpha=2.0)
        jback, jmeta, jv = jreg.resolve_adapter("m", "acme", v1)
        pback, pmeta, pv = preg.resolve_adapter("m", "beta", v2)
        assert (jv, pv) == (v1, v2) == (1, 1)
        assert jmeta["base_version"] == pmeta["base_version"] == base_v
        for b in (np_adapter(jback), np_adapter(pback)):
            for lk, lv in ad.items():
                for pk, ba in lv.items():
                    assert b[lk][pk]["B"].tobytes() == ba["B"].tobytes()
        assert preg.tenants("m") == jreg.tenants("m") == ["acme", "beta"]

    def test_registry_round_trip_and_artifact_fraction(self, tmp_path):
        _, net = tiny_pair()
        reg = ModelRegistry(tmp_path)
        base_v = reg.publish("m", net)
        ad = lora.init_adapter(net, rank=1, seed=1)
        v = reg.publish_adapter("m", "acme", ad, base_version=base_v,
                                rank=1, alpha=2.0)
        back, meta, got_v = reg.resolve_adapter("m", "acme", v)
        assert got_v == v and meta["base_version"] == base_v
        assert meta["rank"] == 1 and meta["alpha"] == 2.0
        full = reg.path("m", base_v).stat().st_size
        delta = reg.adapter_path("m", "acme", v).stat().st_size
        assert delta < 0.25 * full
        assert lora.adapter_bytes(ad) == sum(
            t.numel() * 4 for lv in ad.values() for ba in lv.values()
            for t in ba.values())

    def test_corruption_caught_and_latest_falls_back(self, tmp_path):
        import zipfile
        _, net = tiny_pair()
        reg = ModelRegistry(tmp_path)
        ad = lora.init_adapter(net, rank=1, seed=1)
        reg.publish_adapter("m", "acme", ad, base_version=1, rank=1,
                            alpha=2.0)
        ad2 = random_b(ad, seed=4)
        reg.publish_adapter("m", "acme", ad2, base_version=1, rank=1,
                            alpha=2.0)
        path = reg.adapter_path("m", "acme", 2)
        with zipfile.ZipFile(path) as zf:
            meta, npz = zf.read("meta.json"), zf.read("adapter.npz")
        flat = dict(np.load(__import__("io").BytesIO(npz)))
        k = sorted(flat)[0]
        flat[k] = flat[k] + 1.0                   # the bytes, not the crc
        buf = __import__("io").BytesIO()
        np.savez(buf, **flat)
        with zipfile.ZipFile(path, "w") as zf:
            zf.writestr("adapter.npz", buf.getvalue())
            zf.writestr("meta.json", meta)
        with pytest.raises(ValueError, match="checksum"):
            lora.load_adapter(path)
        with pytest.raises(ValueError, match="checksum"):
            reg.resolve_adapter("m", "acme", 2)
        back, _, v = reg.resolve_adapter("m", "acme")
        assert v == 1
        assert torch.equal(back["2"]["attn_Wq"]["A"],
                           ad["2"]["attn_Wq"]["A"])

    def test_retention_never_collects_pinned(self, tmp_path):
        _, net = tiny_pair()
        reg = ModelRegistry(tmp_path, keep_last=2)
        base_v = reg.publish("m", net)
        ad = lora.init_adapter(net, rank=1)
        v1 = reg.publish_adapter("m", "acme", ad, base_version=base_v,
                                 rank=1, alpha=2.0)
        reg.pin_adapter("m", "acme", v1)
        for _ in range(3):
            last = reg.publish_adapter("m", "acme", ad, base_version=base_v,
                                       rank=1, alpha=2.0)
        assert reg.adapter_path("m", "acme", v1).exists()
        assert v1 in reg.adapter_versions("m", "acme")
        assert last in reg.adapter_versions("m", "acme")
        assert len(reg.adapter_versions("m", "acme")) <= 3
        reg.unpin_adapter("m", "acme", v1)
        assert v1 not in reg.adapter_versions("m", "acme")

    def test_a_live_process_marker_pins(self, tmp_path):
        """A pin taken by another live process (its on-disk marker) keeps
        the version through this process's collections; a dead process's
        marker is swept and its version collected."""
        _, net = tiny_pair()
        reg = ModelRegistry(tmp_path, keep_last=1)
        ad = lora.init_adapter(net, rank=1)
        v1 = reg.publish_adapter("m", "acme", ad, base_version=1, rank=1,
                                 alpha=2.0)
        child = subprocess.Popen(
            [sys.executable, "-c", "import sys; sys.stdin.read()"],
            stdin=subprocess.PIPE)
        try:
            live = reg.adapter_dir("m", "acme") / f".pin-v{v1}.{child.pid}"
            live.touch()
            reg.publish_adapter("m", "acme", ad, base_version=1, rank=1,
                                alpha=2.0)
            assert v1 in reg.adapter_versions("m", "acme")
        finally:
            child.stdin.close()
            child.wait(30)
        reg.publish_adapter("m", "acme", ad, base_version=1, rank=1,
                            alpha=2.0)
        assert v1 not in reg.adapter_versions("m", "acme")
        assert not live.exists()


# ============================================== composed-params cache
@pytest.fixture
def fleet_setup(tmp_path):
    _, net = tiny_pair(layers=2, head_scale=8.0)
    reg = ModelRegistry(tmp_path)
    base_v = reg.publish("m", net)
    ad = lora.init_adapter(net, rank=1)
    reg.publish_adapter("m", "acme", ad, base_version=base_v, rank=1,
                        alpha=2.0)
    fleet = TenantFleet(reg, "m", device="cpu")
    yield fleet, reg, ad
    fleet.stop()


class TestComposedParamsCache:
    def test_cache_hit_and_version_invalidation(self, fleet_setup):
        fleet, _, ad = fleet_setup
        t1 = fleet.composed_params("acme", ad, 1, rank=1, alpha=2.0)
        t2 = fleet.composed_params("acme", ad, 1, rank=1, alpha=2.0)
        assert t1 is t2
        # a fit or restore of the base writes in place and moves its
        # params version: every composition rebuilds
        fleet.base_net.params_changed()
        t3 = fleet.composed_params("acme", ad, 1, rank=1, alpha=2.0)
        assert t3 is not t1

    def test_adapter_version_bump_and_shared_base(self, fleet_setup):
        fleet, _, ad = fleet_setup
        t1 = fleet.composed_params("acme", ad, 1, rank=1, alpha=2.0)
        t2 = fleet.composed_params("acme", ad, 2, rank=1, alpha=2.0)
        assert t2 is not t1
        base = {w.data_ptr() for w in fleet.base_net.parameters()}
        n = 0
        for tree in (t1, t2):
            for lv in tree.params.values():
                for w in lv.values():
                    if isinstance(w, lora.LoRAWeight):
                        assert w.base.data_ptr() in base
                        n += 1
            assert all(isinstance(w, lora.LoRAWeight)
                       for w in tree.installable.values())
        assert n == 2 * 13

    def test_int8_base_is_quantized_once(self, fleet_setup):
        fleet, _, ad = fleet_setup
        t1 = fleet.composed_params("acme", ad, 1, rank=1, alpha=2.0,
                                   quantize="int8")
        t2 = fleet.composed_params("beta", ad, 1, rank=1, alpha=2.0,
                                   quantize="int8")
        b1 = t1.params["2"]["attn_Wq"].base
        b2 = t2.params["2"]["attn_Wq"].base
        assert isinstance(b1, quant.QuantizedTensor) and b1 is b2


# ===================================================== int8 + adapter
def test_int8_base_with_adapter_matches_jax_by_margin():
    V, n_tok = 61, 10
    jnet, net = tiny_pair(vocab=V, d=32, layers=2, heads=4, max_len=40,
                          head_scale=8.0)
    # B at 0.05: the delta moves the function by ~1e-2 in probability
    # while the activations keep the base's scale (at 0.3 they grow 7x,
    # and the two packages' fp32 roundings with them)
    ad = random_b(lora.init_adapter(net, rank=2, seed=6), seed=9, scale=0.05)
    prompts = np.random.default_rng(17).integers(0, V, (4, 6))
    jparams = jlora.compose_params(jquant.serving_params(jnet, "int8"), ad,
                                   rank=2, alpha=4.0)
    old = jnet.params
    try:
        jnet.params = jparams
        want = np.asarray(jax_generate(jnet, prompts, n_tok,
                                       temperature=0))
    finally:
        jnet.params = old
    jprobs = []
    for p, t in zip(prompts, want):
        seq = np.concatenate([p, t[:-1]])[None]
        carries = {str(i): layer.init_carry(1, jnet.dtype.compute_dtype)
                   for i, layer in enumerate(jnet.layers)
                   if isinstance(layer, BaseRecurrentLayer)}
        h = jnet._forward_core(jparams, jnet.net_state, seq, train=False,
                               rng=None, carries=carries)[0]
        jprobs.append(np.asarray(h[0, len(p) - 1:], np.float64))
    view = composed_view(net, ad, 2, 4.0, mode="int8")
    got = generate(view, prompts, n_tok, temperature=0)
    eps = max(float(np.abs(teacher_forced_probs(view, p, t) - jp).max())
              for p, t, jp in zip(prompts, want, jprobs))
    assert eps <= PROB_ATOL, eps
    ties = 0
    for t, g, jp in zip(want, got, jprobs):
        r = stream_agreement(t, g, jp, eps)
        assert r["ok"], r
        ties += r["near_ties"]
    # the adapter and the int8 base each move the function
    fp = teacher_forced_probs(net, prompts[0], want[0])
    assert np.abs(fp - teacher_forced_probs(view, prompts[0],
                                            want[0])).max() > 1e-3
    print(f"int8 + adapter vs JAX: max prob diff {eps:.3g}, near-ties {ties}")


# ======================================================= tenant fleet
def test_tenant_fleet_serves_swaps_and_shares_one_base(tmp_path):
    jnet, net = tiny_pair(layers=2, head_scale=8.0)
    reg = ModelRegistry(tmp_path)
    base_v = reg.publish("m", net)
    ads = {}
    for i, tenant in enumerate(("acme", "beta")):
        for v in (1, 2):
            ad = random_b(lora.init_adapter(net, rank=2, seed=i),
                          seed=10 * i + v)
            ads[(tenant, v)] = ad
            assert reg.publish_adapter("m", tenant, ad, base_version=base_v,
                                       rank=2, alpha=4.0) == v
    prompts = np.random.default_rng(5).integers(0, 12, (4, 5))
    refs = {}
    for key, ad in ads.items():
        lora.attach_adapter(net, ad, rank=2, alpha=4.0)
        refs[key] = generate(net, prompts, 6, temperature=0)
        lora.strip_adapter(net)
        jlora.attach_adapter(jnet, ad, rank=2, alpha=4.0)
        np.testing.assert_array_equal(
            refs[key], np.asarray(jax_generate(jnet, prompts, 6,
                                               temperature=0)))
        jlora.strip_adapter(jnet)
    fleet = TenantFleet(reg, "m", device="cpu")
    try:
        kw = dict(n_slots=4, n_blocks=4 * 3 + 1, block_len=4)
        assert fleet.deploy("acme", version=1, warmup_prompt_len=(5, 5),
                            **kw) == 1
        assert fleet.deploy("beta", version=1, **kw) == 1
        assert fleet.server("acme").engine.goodput.classes["warmup"] > 0
        assert fleet.server("beta").engine.goodput.classes["warmup"] == 0
        assert fleet.shared_base_copies() == 1
        assert reg.pinned() == {("m", base_v)}
        router = FleetRouter(fleet)
        gate = gate_decode(fleet.server("acme"))
        burst = {t: [router.submit(t, p, 6) for p in prompts]
                 for t in ("acme", "beta")}
        wait_first_chunk(burst["acme"])
        assert gate.blocked.wait(10)
        box = {}

        def swap():
            box["v"] = fleet.swap("acme", version=2)

        import threading
        th = threading.Thread(target=swap)
        th.start()
        gate.set()
        th.join(60)
        after = [router.submit("acme", p, 6) for p in prompts]
        assert box["v"] == 2 and fleet.version("acme") == 2
        # the successor ran the same warmup before its flip
        assert fleet.server("acme").engine.goodput.classes["warmup"] > 0
        for tenant, streams in burst.items():
            for i, s in enumerate(streams):
                np.testing.assert_array_equal(
                    np.asarray(s.result(60)), refs[(tenant, s.version)][i])
        for i, s in enumerate(after):
            assert s.version == 2
            np.testing.assert_array_equal(np.asarray(s.result(60)),
                                          refs[("acme", 2)][i])
        assert fleet.shared_base_copies() == 1
        assert reg.adapter_versions("m", "acme") == [1, 2]
        assert not (reg.adapter_dir("m", "acme") /
                    f".pin-v1.{os.getpid()}").exists()
    finally:
        fleet.stop()
    assert reg.pinned() == set()


def test_adapter_publish_listener_publishes_the_delta(tmp_path):
    jnet, net = tiny_pair()
    preg, jreg = ModelRegistry(tmp_path / "p"), JaxRegistry(
        str(tmp_path / "j"))
    for a, n, reg in ((jlora, jnet, jreg), (lora, net, preg)):
        a.attach_adapter(n, a.init_adapter(n, rank=2, seed=1), rank=2,
                         alpha=4.0)
        n.add_listener(reg.adapter_publish_listener(
            "m", "acme", base_version=1, rank=2, alpha=4.0, frequency=2))
    x, y = fit_data(3)
    xs, ys = np.concatenate([x] * 5), np.concatenate([y] * 5)
    jnet.fit(xs, ys, epochs=1, batch_size=4, shuffle=False)
    net.fit(xs, ys, epochs=1, batch_size=4, shuffle=False)
    pl, jl = net.listeners[-1], jnet.listeners[-1]
    assert pl.published_steps == jl.published_steps == [2, 4, 5]
    assert pl.published_versions == jl.published_versions == [1, 2, 3]
    for v in pl.published_versions:
        got, meta, _ = preg.resolve_adapter("m", "acme", v)
        want, jmeta, _ = jreg.resolve_adapter("m", "acme", v)
        assert meta["step"] == jmeta["step"]
        assert_adapters_close(got, want, FIT_RTOL, 1e-7)
    with pytest.raises(ValueError, match="no attached adapter"):
        lora.strip_adapter(net)
        pl._publish(net, 6)
