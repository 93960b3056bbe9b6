"""The port's online-learning loop and multi-tenant drill
(`deeplearning4j_tpu_torch/scripts/{online_loop,tenant_loadtest}.py`)
end to end on the CPU: `main(["--smoke", "--device", "cpu"])` exits 0
(every hard assert of the JAX scripts' docstrings held: publishes,
mid-traffic hot-swaps, zero dropped streams, version-tagged greedy
parity, the drift gate's trip and recovery; for tenants also one shared
base copy, adapter artifacts under 5% of the zip, the membership
change, the fair-share floor and the frozen base) over both transports
of the online loop, and each ledger carries the keys of JAX's (read
from `scripts/online_loop.py` and `scripts/tenant_loadtest.py`'s
`main`). The drills run on the real clock: their asserts are counts and
orders, never a time."""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import json

import pytest

import torch_port_drivers as tpd
from deeplearning4j_tpu_torch.scripts import online_loop, tenant_loadtest


@pytest.mark.parametrize("transport", ["log", "queue"])
def test_online_loop_smoke(tmp_path, transport):
    out = tmp_path / "online.json"
    rc = online_loop.main(["--smoke", "--device", "cpu", "--transport",
                           transport, "--out", str(out)])
    assert rc == 0
    got = json.loads(out.read_text())
    want = tpd.jax_ledger_keys("online_loop", "verdict")
    assert set(got) == set(want)
    tpd.assert_keys_cover(want, got, "verdict")
    assert got["platform"] == "cpu" and got["config"]["transport"] == transport
    assert got["serving"]["dropped"] == 0 and got["serving"]["swaps"] >= 1
    assert got["train"]["drift_trips"] >= 1


def test_tenant_loadtest_smoke(tmp_path):
    out = tmp_path / "tenancy.json"
    rc = tenant_loadtest.main(["--smoke", "--device", "cpu", "--out",
                               str(out)])
    assert rc == 0
    got = json.loads(out.read_text())
    want = tpd.jax_ledger_keys("tenant_loadtest", "rec")
    assert set(got) == set(want)
    tpd.assert_keys_cover(want, got, "rec")
    tpd.assert_keys_cover(want["extras"], got["extras"], "extras")
    t = got["extras"]["serving_tenancy"]
    assert t["shared_base_copies"] == 1 and t["dropped"] == 0
    assert t["base_frozen"] == "bit-identical"


def test_tenant_loadtest_refuses_a_dispatch_floor():
    with pytest.raises(SystemExit):
        tenant_loadtest.main(["--device", "cpu", "--dispatch-floor-ms",
                              "3"])
