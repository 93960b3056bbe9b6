"""Phase 22 of `chip_smoke.py` (the embedding engine and the graph
library: the word2vec bench config and the 100k vocab, the other three
Word2Vec modes, ParagraphVectors, GloVe, DeepWalk, Node2Vec and the
packaged vectors, each card run held against the port's CPU path)
rehearsed on the CPU in its small mode. A file of its own, so that
`--dist loadfile` runs it beside the other rehearsals."""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import torch

import chip_smoke


def test_phase_22_small_mode_on_the_cpu():
    """`chip_smoke.phase_embeddings` at its CPU size: every check passes
    and no hand-written kernel launches. With both sides on the CPU the
    "card" runs equal the CPU twins bit for bit, and the scatter-order
    twin is the one run that differs."""
    report, fails = {}, chip_smoke.Failures()
    launches = chip_smoke.phase_embeddings(torch.device("cpu"), report,
                                           fails, small=True)
    assert not fails, list(fails)
    assert launches == {}
    r = report["embeddings"]
    a, b = r["a"], r["b"]
    assert a["first_group_rel"] == [0.0, 0.0]
    assert b["first_group_rel"] == [0.0, 0.0]
    assert a["fit_rel_card"] == 0.0 < a["fit_rel_twin"]
    assert a["nearest_overlap"] == 1.0
    assert a["words"] == (chip_smoke.W2V_SMALL["n_sent"]
                          * chip_smoke.W2V_SMALL["sent_len"])
    assert a["words_per_s"] > 0 and a["etl"]["mode"] == "async"
    assert b["cpu_fit_s"] is None        # the CPU stopped after a group
    assert set(r["c"]) == set(chip_smoke.EMBED_MODES)
    assert all(max(m["rel"]) == 0.0 for m in r["c"].values())
    assert set(r["d"]) == {"pv_dbow", "pv_dm", "pv_infer", "glove",
                           "deepwalk", "node2vec"}
    assert all(max(m["rel"]) == 0.0 for m in r["d"].values())
    e = r["e"]
    assert e["nearest_unequal"] == [] and e["queries"] == 50
    assert e["binary_bit_equal"] and e["text_bit_equal"]
