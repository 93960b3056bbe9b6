"""Phase 19 of `chip_smoke.py` (elastic training on the long-context LM:
the survive-the-kill drill in 2 worker processes over gloo with its
federated telemetry and alerts, and the in-process trainer over a join
and a leave in dense sync) rehearsed on the CPU in its small mode. A
file of its own, so that `--dist loadfile` runs it beside the other
rehearsals."""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import torch

import chip_smoke
from deeplearning4j_tpu_torch.parallel import elastic_smoke


def test_phase_19_small_mode_on_the_cpu():
    """`chip_smoke.phase_elastic` at its CPU size: every check passes,
    the drill ran three generations of widths 2, 1, 2 and no kernel
    launches."""
    report, fails = {}, chip_smoke.Failures()
    launches = chip_smoke.phase_elastic(torch.device("cpu"), report, fails,
                                        small=True)
    assert not fails, list(fails)
    assert all(n == 0 for n in launches.values())
    r = report["elastic"]
    assert r["config"]["backend"] == "gloo"
    a = r["a"]
    assert a["generations"] == [1, 2, 3] and a["widths"] == [2, 1, 2]
    assert a["steps_lost"] == 1
    assert a["max_loss_drift"] <= 0.25 * a["initial_loss"]
    # the drill is the scheduled run, step by step and in its params
    assert a["schedule_loss_rel"] <= elastic_smoke.LOSS_RTOL
    assert a["param_motion"] <= elastic_smoke.PARAM_MOTION_RTOL
    for what in ("shrink", "regrow"):
        assert a["timeline"][what]["total_s"] > 0
    t = a["telemetry"]
    assert "firing" in t["elastic_shrink"]
    assert t["elastic_shrink"][-1] == "resolved"
    b = r["b"]
    assert [h["n_workers"] for h in b["history"]] == [4, 2, 4]
    assert b["loss_rel"] <= chip_smoke.TRAIN_LOSS_RTOL
    assert b["metrics"] == {"elastic_generation": 3.0,
                            "elastic_drains_total": 2.0,
                            "elastic_resume_total": 2.0}
    assert set(r["launches_by_part"]) <= set(chip_smoke.ELASTIC_KERNELS)
