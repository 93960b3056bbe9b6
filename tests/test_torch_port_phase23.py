"""Phase 23 of `chip_smoke.py` (k-means, t-SNE, Viterbi, the segmenters'
Word2Vec fits and the kNN server, each card run held against the port's
CPU path) and its phase 2 Viterbi checks, rehearsed on the CPU in their
small mode. A file of its own, so that `--dist loadfile` runs it beside
the other rehearsals."""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import numpy as np
import torch

import chip_smoke


def test_phase_23_small_mode_on_the_cpu():
    """`chip_smoke.phase_clustering` at its CPU size: every check passes
    and the Viterbi kernel launches nothing. With both sides on the CPU
    the "card" runs equal the CPU's bit for bit; the one-ulp t-SNE twin
    is the one run that differs."""
    report, fails = {}, chip_smoke.Failures()
    launches = chip_smoke.phase_clustering(torch.device("cpu"), report,
                                           fails, small=True)
    assert not fails, list(fails)
    assert launches == {"viterbi": 0}
    r = report["clustering"]
    assert r["vectors"]["shape"][1] == chip_smoke.W2V_SMALL["layer"]
    a = r["a"]
    assert a["assignments_apart"] == [] and a["centroids_rel"] == 0.0
    assert a["iterations"] == a["iterations_cpu"] >= 1
    b = r["b_i"]
    assert b["points"] == [1032, 64]
    assert b["step_rel_max"] == 0.0 and b["gains_flipped"] == 0
    n = chip_smoke.TSNE_STEPS
    assert b["free_rel"][n] == 0.0 < b["twin_rel"][n]
    bb = r["b_ii"]
    assert bb["kl_end"] < bb["kl_first_plain"]
    assert bb["overlap"] >= chip_smoke.TSNE_CHANCE_FACTOR * bb[
        "overlap_chance"]
    assert set(r["c"]) == {"noisy_labels", "lm_vocab"}
    assert all(c["bit_equal"] and c["launches"] == 0
               for c in r["c"].values())
    assert set(r["d"]) == {"cjk", "japanese", "korean", "annotation"}
    assert all(max(d["rel"]) == 0.0 and all(d["structure"].values())
               for d in r["d"].values())
    e = r["e"]
    assert e["unequal"] == 0 and e["queries"] == 2 * chip_smoke.SERVER_QUERIES


def test_phase_2_viterbi_checks_small_mode_on_the_cpu():
    checks, fails = [], chip_smoke.Failures()
    timings = chip_smoke._viterbi_checks(torch.device("cpu"), checks, fails,
                                         None, small=True)
    assert not fails, list(fails)
    cases = [c["case"] for c in checks]
    assert cases == ["S2", "S77", "S512", "S1100", "T1", "ragged", "ties",
                     "noisy_labels", "lm_vocab"]
    assert all(c["ok"] and c["kernel"] == "viterbi" for c in checks)
    main = timings[("viterbi", "float32")]
    assert main["library_ms"] is None
    assert main["bound"][1] == "bytes"          # at the rehearsal's size
    T, S = chip_smoke.VITERBI_CHAIN_SHAPE
    ms, by = chip_smoke.viterbi_bound(T, S)
    assert by == "operations" and 0.01 < ms < 0.013


def test_viterbi_chain_is_metastable_with_flips():
    obs = chip_smoke.viterbi_chain(20000, 77, seed=23)
    assert obs.shape == (20000,) and 0 <= obs.min() and obs.max() < 77
    changes = np.count_nonzero(np.diff(obs))
    # hops (2 %) and flips (1 %, each one in and one out)
    assert 0.02 * 20000 < changes < 0.06 * 20000


def test_kernels_line_lists_viterbi():
    src, replaces = chip_smoke.KERNEL_META["viterbi"]
    assert src == "deeplearning4j_tpu_torch/kernels/csrc/viterbi.cu"
    assert replaces.startswith("deeplearning4j_tpu/util/viterbi.py:27")


def test_phase_9_d_cpu_reference_equals_evaluate():
    """Phase 9 (d)'s CPU reference (the budget this PR's phase 23 won
    back): `Evaluation` and `ROCMultiClass` fed the CPU twin's one
    `output()` give what `evaluate()` and `evaluate_roc_multi_class()`
    give over the same held-out set in batches of 128."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
    from deeplearning4j_tpu_torch.eval.roc import ROCMultiClass
    cfg = dict(chip_smoke.CLS, n_layers=1, max_len=32, vocab=64, d_model=32,
               n_heads=2)
    net = chip_smoke.build_classifier(cfg, "cpu")
    Xe, Me, Ye = chip_smoke.classifier_data(cfg, 200, seed=23)
    ds = DataSet(Xe, Ye, features_mask=Me)
    e_ref, r_ref = net.evaluate(ds), net.evaluate_roc_multi_class(ds)
    p = net.output(Xe, mask=Me).numpy()
    e, r = Evaluation(), ROCMultiClass()
    e.eval(Ye, p)
    r.eval(Ye, p)
    assert np.array_equal(e.confusion.matrix, e_ref.confusion.matrix)
    assert e.accuracy() == e_ref.accuracy()
    for c in range(cfg["classes"]):
        assert abs(r.calculate_auc(c) - r_ref.calculate_auc(c)) <= 1e-12
