"""Phase 16 of `chip_smoke.py` (the serving request plane: monitoring on
and off, goodput, SLO shedding, DLFP handoffs, the decode cost report,
tokens/s) rehearsed on the CPU in its small mode. A file of its own, so
that `--dist loadfile` runs it beside the other rehearsals."""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import torch

import chip_smoke


def test_phase_16_small_mode_on_the_cpu():
    """`chip_smoke.phase_serving_plane` at its CPU size: every check
    passes and no kernel launches."""
    report, fails = {}, chip_smoke.Failures()
    launches = chip_smoke.phase_serving_plane(torch.device("cpu"), report,
                                              fails, small=True)
    assert not fails, list(fails)
    assert all(n == 0 for n in launches.values())
    r = report["serving_plane"]
    assert r["sync"]["streams_equal"]
    assert r["sync"]["reads_off"] == r["sync"]["reads_on"] > 0
    assert r["shed"]["shed"] == r["shed"]["serving_shed_total"] > 0
    assert all(h["streams_bit_equal"] for h in r["handoff"].values())
    assert r["handoff"]["mixed_bf16"]["dtype"] == "torch.bfloat16"
    for snap in r["goodput"].values():
        assert sum(snap[c] for c in ("useful", "spec_rejected", "pad_waste",
                                     "warmup", "preempt_discard",
                                     "drain")) == snap["dispatched_total"]
    assert r["cost"]["predicted_ms"] > 0 and r["rate"]["tokens_per_s_on"] > 0
    assert r["rate"]["dispatch_ms_off"] > 0 and r["rate"]["dispatch_ms_on"] > 0
