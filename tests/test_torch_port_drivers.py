"""The port's serving load test and fault drill
(`deeplearning4j_tpu_torch/scripts/{serve_loadtest,fault_drill}.py`)
held to the repository's JAX scripts (`scripts/serve_loadtest.py`,
`scripts/fault_drill.py`, loaded by path), on the CPU:

- `clamp_to_waves`, `goodput_block` and `_chi2_two_sample` equal JAX's
  on the same inputs;
- at JAX's `--smoke` widths (d16, vocab 101, 2 layers, 4 heads) with
  the weights of JAX's `build_net(seed=11)` carried into the port, the
  port's `reference_tokens` streams equal JAX's by `stream_agreement`
  margin, and `concurrency_ab`'s admitted counts are equal;
- the port's `main(["--smoke", "--skip-fleet", "--skip-replicated",
  "--skip-spec", "--device", "cpu"])` exits 0 and its ledger's phase
  1-3 blocks carry JAX's keys (read from JAX's `main` source). The
  speculative phases 5-9 run in `test_torch_port_drills_serving.py`
  through the spec smokes;
- the fault drill's `--smoke --with-corruption --device cpu` exits 0
  with a bit-identical verdict; the uninterrupted reference's dump
  equals JAX's `run_child` dump within 1e-5 of each tensor's largest
  value (JAX's init is drawn to erfinv's last place), and each
  package's `_compare` reads the other's dump.
"""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import argparse
import json

import numpy as np
import pytest

import torch_port_drivers as tpd
from deeplearning4j_tpu_torch.scripts import fault_drill, serve_loadtest
from deeplearning4j_tpu_torch.util.jax_params import (
    from_jax_params, to_numpy_params)

SMOKE = dict(vocab=101, d_model=16, n_layers=2, n_heads=4)
N_TOK = 24
INIT_ATOL = 1e-5      # of each tensor's largest |value|


@pytest.fixture(scope="module")
def jsl():
    return tpd.load_jax_script("serve_loadtest")


@pytest.fixture(scope="module")
def twin(jsl):
    """JAX's smoke-width `build_net(seed=11)` and the port's net with its
    weights, on the CPU."""
    max_len = 8 + N_TOK + 4
    jnet = jsl.build_net(SMOKE["vocab"], SMOKE["d_model"],
                         SMOKE["n_layers"], SMOKE["n_heads"], max_len)
    from deeplearning4j_tpu_torch.zoo.transformer import TransformerLM
    net = TransformerLM(SMOKE["vocab"], d_model=SMOKE["d_model"],
                        n_layers=SMOKE["n_layers"],
                        n_heads=SMOKE["n_heads"],
                        max_len=max_len).init(device="cpu")
    return jnet, from_jax_params(net, to_numpy_params(jnet.params))


# ------------------------------------------------------------ helpers
@pytest.mark.parametrize("n, slots", [(128, 16), (100, 8), (7, 4),
                                      (12288, 16), (32, 8), (0, 3)])
def test_clamp_to_waves_equals_jax(jsl, capsys, n, slots):
    want = jsl.clamp_to_waves(n, slots, "--streams")
    jout = capsys.readouterr().out
    assert serve_loadtest.clamp_to_waves(n, slots, "--streams") == want
    assert capsys.readouterr().out == jout


def test_goodput_block_equals_jax(jsl):
    from deeplearning4j_tpu.monitor.goodput import GOODPUT_CLASSES
    rng = np.random.default_rng(4)
    counts = {c: int(rng.integers(0, 500)) for c in GOODPUT_CLASSES}
    total = sum(counts.values())
    gp = dict(counts, dispatched_total=total,
              goodput_fraction=counts["useful"] / total)
    parts = [dict(queue_wait_s=float(a), prefill_s=float(b),
                  first_emit_s=float(c))
             for a, b, c in rng.random((9, 3)) * 0.1]
    for stats in ({"goodput": gp, "goodput_conserved": True},
                  {"goodput": gp, "goodput_conserved": False,
                   "ttft_parts": parts}):
        assert serve_loadtest.goodput_block(stats) == \
            jsl.goodput_block(stats)


@pytest.mark.parametrize("seed, vocab", [(0, 101), (1, 512), (2, 7)])
def test_chi2_two_sample_equals_jax(jsl, seed, vocab):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, vocab, 256)
    b = np.minimum(rng.integers(0, vocab, 256) + (seed == 2), vocab - 1)
    assert serve_loadtest._chi2_two_sample(a, b, vocab) == \
        jsl._chi2_two_sample(a, b, vocab)
    assert serve_loadtest._chi2_crit(17) == jsl._chi2_crit(17)


# ------------------------------------------------ the smoke-width LM
def test_reference_tokens_match_jax_by_margin(jsl, twin):
    """Whole-batch greedy references, mixed prompt lengths: each port
    stream equals JAX's, or first differs at a near-tie of the port's
    teacher-forced probabilities (at the largest probability difference
    measured between the packages)."""
    from deeplearning4j_tpu_torch.zoo.transformer import (
        stream_agreement, teacher_forced_probs)
    jnet, net = twin
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, SMOKE["vocab"], (2, 4, 8)[i % 3])
               for i in range(12)]
    want = jsl.reference_tokens(jnet, prompts, N_TOK)
    got = serve_loadtest.reference_tokens(net, prompts, N_TOK)
    eps, probs = 0.0, []
    for p, w in zip(prompts, want):
        seq = np.concatenate([p, np.asarray(w)[:-1]])[None]
        jp = np.asarray(jnet.output(seq.astype(np.float32)))[0][len(p) - 1:]
        tp = teacher_forced_probs(net, p, w)
        eps = max(eps, float(np.abs(jp - tp).max()))
        probs.append(tp)
    assert eps < 1e-5
    equal = 0
    for w, g, tp in zip(want, got, probs):
        rep = stream_agreement(w, g, tp, eps)
        assert rep["ok"], rep
        equal += rep["first_diff"] is None
    assert equal >= len(prompts) - 1


def test_concurrency_ab_equals_jax(jsl, twin):
    jnet, net = twin
    kw = dict(n_slots=8, n_blocks=9, block_len=4)
    want = jsl.concurrency_ab(jnet, 2, N_TOK, **kw)
    assert serve_loadtest.concurrency_ab(net, 2, N_TOK, **kw) == want
    assert want["incremental"] >= 2 * want["upfront"]


def test_greedy_parity_records_a_near_tie(twin):
    """A stream that first differs at a near-tie of its reference is
    held, and recorded with its margin; one that differs elsewhere is
    broken."""
    from deeplearning4j_tpu_torch.zoo.transformer import (
        teacher_forced_probs)
    _, net = twin
    p = np.arange(4) % SMOKE["vocab"]
    ref = serve_loadtest.reference_tokens(net, [p], N_TOK)[0]
    probs = teacher_forced_probs(net, p, ref)
    top = np.sort(probs, axis=-1)
    gaps = top[:, -1] - top[:, -2]
    at = int(np.argmin(gaps))
    got = np.array(ref)
    got[at] = np.argsort(probs[at])[-2]
    ties = []
    ok = serve_loadtest.greedy_parity(net, [p], [ref], [got], ties=ties)
    assert ok == (gaps[at] <= serve_loadtest.NEAR_TIE_EPS)
    if ok:
        assert ties == [(0, at, pytest.approx(gaps[at]))]
    wide = int(np.argmax(gaps))
    got = np.array(ref)
    got[wide] = np.argsort(probs[wide])[-2]
    assert not serve_loadtest.greedy_parity(net, [p], [ref], [got])
    assert serve_loadtest.greedy_parity(net, [p], [ref], [np.array(ref)])


def test_main_smoke_exits_zero_with_jax_keys(jsl, tmp_path):
    out = tmp_path / "serving.json"
    rc = serve_loadtest.main(["--smoke", "--skip-fleet",
                              "--skip-replicated", "--skip-spec",
                              "--device", "cpu", "--out", str(out)])
    assert rc == 0
    rec = json.loads(out.read_text())
    want = tpd.jax_ledger_keys("serve_loadtest", "record")
    assert set(rec) - {"near_ties", "seconds"} == set(want)
    assert set(rec["config"]) == set(want["config"])
    tpd.assert_keys_cover(want["extras"], rec["extras"], "extras")
    assert set(rec["extras"]) == {"serving", "serving_mixed_quantized",
                                  "goodput"}
    assert rec["extras"]["serving"]["greedy_parity"] in (
        "exact", f"near-tie ({len(rec['near_ties']['serving'])} streams)")
    assert rec["platform"] == "cpu"
    gp = rec["extras"]["goodput"]
    assert gp["conserved"] and set(gp) == set(jsl.goodput_block(
        {"goodput": {"dispatched_total": 1, "goodput_fraction": 0.5,
                     **{c: 0 for c in gp["class_fractions"]}},
         "goodput_conserved": True,
         "ttft_parts": [dict(queue_wait_s=0.0, prefill_s=0.0,
                             first_emit_s=0.0)]}))


def test_ledger_refuses_a_bench_record(tmp_path):
    from deeplearning4j_tpu_torch.scripts import _common
    with pytest.raises(ValueError, match="BENCH_"):
        _common.write_ledger(tmp_path / "BENCH_serving.json", {})
    assert not (tmp_path / "BENCH_serving.json").exists()


# -------------------------------------------------------- fault drill
def test_fault_drill_smoke_with_corruption_exits_zero():
    rc, stdout, stderr, last = tpd.run_port_module(
        "scripts.fault_drill", "--smoke", "--with-corruption", "--device",
        "cpu", timeout=300)
    assert rc == 0, stderr[-2000:]
    rep = last["fault_drill"]
    assert rep["ok"] and rep["differences"] == [] and rep["restarts"] == 0
    assert rep["killed_rc"] == -15 and rep["corrupted"]
    assert rep["kill_to_resume_s"] > 0 and rep["work_dir"] is None
    assert "bit-identically (with corrupted-newest fallback)" in stdout


def _child_args(out, **kw):
    a = dict(out=str(out), ckpt_dir=None, kill_at=None, resume=False,
             ckpt_freq=5, device="cpu", stamp=None)
    a.update(kw)
    return argparse.Namespace(**a)


def test_drill_dumps_match_jax_and_cross_read(tmp_path):
    jfd = tpd.load_jax_script("fault_drill")
    jpath, ppath = tmp_path / "jax.npz", tmp_path / "port.npz"
    assert jfd.run_child(_child_args(jpath)) == 0
    assert fault_drill.run_child(_child_args(ppath)) == 0
    with np.load(jpath) as a, np.load(ppath) as b:
        assert sorted(a.files) == sorted(b.files)
        assert any(k.startswith("updater") for k in a.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            scale = max(1.0, float(np.abs(a[k]).max())) \
                if k == "__counters__" else float(np.abs(a[k]).max())
            assert np.abs(a[k] - b[k]).max() <= INIT_ATOL * scale, k
        np.testing.assert_array_equal(a["__counters__"], [30, 3])
    for cmp in (jfd._compare, fault_drill._compare):
        for x, y in ((jpath, ppath), (ppath, jpath)):
            assert not [d for d in cmp(x, y) if "missing" in d]
        assert cmp(jpath, jpath) == [] and cmp(ppath, ppath) == []
