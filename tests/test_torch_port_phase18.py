"""Phase 18 of `chip_smoke.py` (multi-process data parallelism in 2
processes over gloo against one process, the barrier checkpoint and its
resume, the sharded trainer in one process and across two, MoE on an
expert axis, a ShardedCheckpoint round trip, the pipelined trainer, the
graph ring and threshold diagnostics) rehearsed on the CPU in its small
mode. A file of its own, so that `--dist loadfile` runs it beside the
other rehearsals."""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import torch

import chip_smoke


def test_phase_18_small_mode_on_the_cpu():
    """`chip_smoke.phase_multiprocess` at its CPU size: every check
    passes, the workers ran on gloo, and no kernel launches."""
    report, fails = {}, chip_smoke.Failures()
    launches = chip_smoke.phase_multiprocess(torch.device("cpu"), report,
                                             fails, small=True)
    assert not fails, list(fails)
    assert all(n == 0 for n in launches.values())
    r = report["multiprocess"]
    assert r["backend"] == "gloo"
    assert set(r["a"]) == {"dense_bucketed", "dense_single_barrier",
                           "threshold"}
    assert all(a["bytes_per_step"] > 0 for a in r["a"].values())
    assert r["b"]["bit_equal"] and r["b"]["resumed_at"] == 2
    c = r["c"]
    # one process holds every shard once; each of two holds its half of
    # the sharded leaves
    assert c["memory"]["held_between_steps"] == c["memory"]["held_whole"]
    two = c["two_process"]["memory"]
    assert two["held_between_steps"] < two["held_whole"]
    assert set(r["launches_by_part"]) <= set(chip_smoke.MP_KERNELS)
    assert c["moe"]["expert_sharded_leaves"] > 0
    assert c["checkpoint"]["output_equal"]
    assert set(r["d"]) == {"pipe4", "pipe2_data2"}
    assert r["d"]["pipe4"]["bubble_share"] == 3 / 7
    assert r["e"]["diag_bit_equal"] and r["e"]["diag_skipped"] == 0
