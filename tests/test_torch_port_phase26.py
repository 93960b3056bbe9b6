"""Phase 26 of `chip_smoke.py` (the repository's drivers on the port:
the serving load test in process, the fault drill as a subprocess, the
online and tenant drills, the examples) rehearsed on the CPU in its
small mode. A file of its own, so that `--dist loadfile` runs it beside
the other rehearsals."""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import pytest
import torch

import chip_smoke


def test_phase_26_small_mode_on_the_cpu(monkeypatch):
    """Every check passes and no hand-written kernel launches on the
    CPU; each part reports what the phase prints."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")     # the drill's children
    report, fails = {}, chip_smoke.Failures()
    launches = chip_smoke.phase_drivers(torch.device("cpu"), report, fails,
                                        small=True)
    assert not fails, list(fails)
    assert set(launches) == set(chip_smoke.KERNEL_META)
    assert not any(launches.values())
    r = report["drivers"]
    a = r["a"]
    assert a["platform"] == "cpu" and a["parity"] == "exact"
    assert a["reduction"] >= 2.5 and a["shed"] >= 1
    assert a["tok_s"] > 0 and a["seq_tok_s"] > 0
    b = r["b"]
    assert b["rc"] == 0 and b["ok"] and b["kill_to_resume_s"] > 0
    for k in ("c_online", "c_tenant"):
        assert r[k]["dropped"] == 0 and r[k]["trips"] >= 1
    assert r["c_tenant"]["base_copies"] == 1
    assert set(r["d"]) == set(chip_smoke.DRIVER_EXAMPLE_CUTS)
    assert all(v["ok"] for v in r["d"].values())
    assert set(r["part_seconds"]) >= {"a", "b", "c_online", "c_tenant"}


def test_phase_26_cuts_only_steps():
    """The card's example cuts name module constants of the examples and
    only shorten them."""
    import importlib
    for name, cut in chip_smoke.DRIVER_EXAMPLE_CUTS.items():
        mod = importlib.import_module(
            f"deeplearning4j_tpu_torch.examples.{name}")
        for k, v in cut.items():
            assert v <= getattr(mod, k), (name, k)


def test_drivers_flag_needs_a_card():
    """`--drivers` runs phase 26 alone on a card; without CUDA the script
    exits 2 before any phase."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the exit path is not taken")
    assert chip_smoke.main(["--drivers"]) == 2
