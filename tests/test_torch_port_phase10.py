"""Phase 10 of `chip_smoke.py` (ResNet-50, the graph zips, the LM as a
graph) rehearsed on the CPU in its small mode. A file of its own, so
that `--dist loadfile` runs it beside the other rehearsals."""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import torch

import chip_smoke


def test_phase_10_small_mode_on_the_cpu():
    """`chip_smoke.phase_resnet` at its CPU size: ResNet-50 at 64x64 card
    (here: the CPU) against the CPU, the timed arms, the JAX graph zip
    against its golden and a round trip, the LM as a graph against the
    layer list; every check passes and no kernel launches."""
    report, fails = {}, chip_smoke.Failures()
    launches = chip_smoke.phase_resnet(torch.device("cpu"), report, fails,
                                       small=True)
    assert not fails, list(fails)
    assert all(n == 0 for n in launches.values())
    r = report["resnet"]
    assert r["graph_bridge"]["round_trip_bit_equal"]
    assert r["graph_lm_float32"]["packed_runs"] == [[2, 3]]
    assert r["float32"]["steps"] == 2 and r["mixed_bf16"]["steps"] == 2
