"""Phase 21 of `chip_smoke.py` (multi-tenant LoRA serving and online
training on the smoke LM: three tenants' adapters trained online on one
frozen base and published, the drift gate, the resume from the stream
offset, and the TenantFleet serving all three from one base copy with a
swap each) rehearsed on the CPU in its small mode. A file of its own, so
that `--dist loadfile` runs it beside the other rehearsals."""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import os

import torch

import chip_smoke


def test_phase_21_small_mode_on_the_cpu():
    """`chip_smoke.phase_tenancy` at its CPU size: every check passes, no
    kernel launches; every adapter zip equals its factors; the base stays
    bit-identical; the drift gate trips, refuses and recovers; the resume
    is bit-equal; the fleet drops no stream and holds one base copy."""
    report, fails = {}, chip_smoke.Failures()
    launches = chip_smoke.phase_tenancy(torch.device("cpu"), report, fails,
                                        small=True)
    assert not fails, list(fails)
    assert all(n == 0 for n in launches.values())
    r = report["tenancy"]
    c = chip_smoke.TENANCY_SMALL
    a = r["a"]
    assert a["base_bit_identical"]
    assert all(f < 0.05 for f in a["zip_fraction"].values())
    for t in chip_smoke.TENANTS[:-1]:
        assert a[t]["steps"] == c["steps"] and len(a[t]["versions"]) == 2
        assert all(a[t]["bit_equal"].values())
    g = a[chip_smoke.TENANTS[-1]]
    assert g["steps"] == sum(c["drift"])
    assert g["gate"]["trips"] >= 1 and g["gated_skips"] >= 1
    assert not g["gate"]["paused"] and len(g["versions"]) >= 2
    cc = r["c"]
    assert cc["resumed_at"] == c["resume_at"] and cc["factors_bit_equal"]
    assert cc["losses"] == cc["want"]
    d = r["d"]
    assert d["shared_base_copies"] == [1, 1]
    assert all(d["attach_equals_compose"].values())
    assert all(v is not None for v in d["v2_leaves_base_at"].values())
    for t, p in d["per_tenant"].items():
        assert p["dropped"] == 0
        assert p["streams"] == c["burst"] + c["after"]
        assert p["v2_streams"] >= c["after"]
    assert d["hold"]["apart"] == []
    assert set(r["launches_by_part"]) == set(chip_smoke.TENANCY_KERNELS)
    # the registry root is gone
    assert not [n for n in os.listdir(chip_smoke.OUT_DIR)
                if n.startswith("tenancy_registry_")]
