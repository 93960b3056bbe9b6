"""Phase 17 of `chip_smoke.py` (data-parallel training on a 4-way data
axis: the sync dense exchanges against the single card, threshold with
its error-feedback identity, averaging rounds, dense_rs bit-equal to
dense, kill-and-resume and the elastic residual, ParallelInference's
coalescing, the LeNet masters and early stopping) rehearsed on the CPU
in its small mode. A file of its own, so that `--dist loadfile` runs it
beside the other rehearsals."""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import torch

import chip_smoke


def test_phase_17_small_mode_on_the_cpu():
    """`chip_smoke.phase_parallel` at its CPU size: every check passes
    and no kernel launches."""
    report, fails = {}, chip_smoke.Failures()
    launches = chip_smoke.phase_parallel(torch.device("cpu"), report, fails,
                                         small=True)
    assert not fails, list(fails)
    assert all(n == 0 for n in launches.values())
    r = report["parallel"]
    assert r["dense_single_barrier"]["step0_rel"] == 0.0
    assert r["dense_bucketed"]["step0_rel"] <= 1e-5
    assert r["ef_identity"]["sent"] > 0
    assert r["dense_rs"]["bit_equal"] and r["dense_rs"]["sharded_leaves"]
    assert [s for _, s in r["averaging"]["equal_after_step"]] == [
        False, True, False, True]
    assert all(x["bit_equal"] for x in r["resume"].values())
    assert r["resume"]["threshold"]["elastic"]["sum_kept"]
    assert max(r["inference"]["batches"]) > 1
    g = r["lenet"]
    assert g["card"]["shared_phases"] == g["cpu"]["shared_phases"]
    assert set(r["times"]) == {"single_card", "dense_bucketed",
                               "dense_single_barrier", "dense_mixed",
                               "threshold", "dense_rs", "threshold_rs",
                               "averaging"}
