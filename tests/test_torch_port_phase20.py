"""Phase 20 of `chip_smoke.py` (the serving fleet on the smoke LM: the
publishing fit, the hot swap behind the router, the autoscaled resize,
two replicas behind the coordinator with one spawned process killed,
and the streaming route) rehearsed on the CPU in its small mode, the
replica process on `--device cpu`. A file of its own, so that
`--dist loadfile` runs it beside the other rehearsals."""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import os

import torch

import chip_smoke


def test_phase_20_small_mode_on_the_cpu(monkeypatch):
    """`chip_smoke.phase_fleet` at its CPU size: every check passes, no
    kernel launches, the swap's streams carry both versions, the kill
    migrates streams and the route answers within OUTPUT_ATOL."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")   # the spawned replica's
    report, fails = {}, chip_smoke.Failures()
    launches = chip_smoke.phase_fleet(torch.device("cpu"), report, fails,
                                      small=True)
    assert not fails, list(fails)
    assert all(n == 0 for n in launches.values())
    r = report["fleet"]
    c = chip_smoke.FLEET_SMALL
    a = r["a"]
    assert a["versions"] == [1, 2] and a["published_steps"] == [3, 6]
    assert a["bit_equal"] == {1: True, 2: True}
    b = r["b"]
    assert b["dropped"] == 0
    assert b["streams"] == c["greedy"] + c["sampled"] + c["after"]
    assert b["v1_streams"] >= 1 and b["v2_streams"] >= c["after"]
    assert b["pinned"] == [("lm", 2)] and b["versions_left"] == [2]
    assert b["hold"]["apart"] == [] and b["swap_s"] > 0
    cc = r["c"]
    assert cc["decision"]["before"]["n_slots"] == c["n_slots"]
    assert cc["decision"]["after"]["n_slots"] == 2 * c["n_slots"]
    assert "queue_depth" in cc["decision"]["reason"]
    assert cc["dropped"] == 0 and cc["hold"]["apart"] == []
    d = r["d"]
    assert d["migrations"] > 0 and d["dropped"] == 0
    assert d["on_spawned"] >= 1 and d["hold"]["apart"] == []
    assert d["spawn_to_ready_s"] > 0 and d["kill_to_converged_s"] > 0
    e = r["e"]
    assert e["served"] == 2
    assert e["shape"] == [c["route_B"], c["route_T"], 512]
    assert e["max_abs_err"] <= chip_smoke.OUTPUT_ATOL
    assert set(r["launches_by_part"]) == set(chip_smoke.FLEET_KERNELS)
    # the registry root is gone
    assert not [n for n in os.listdir(chip_smoke.OUT_DIR)
                if n.startswith("fleet_registry_")]
