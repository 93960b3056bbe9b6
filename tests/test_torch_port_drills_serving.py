"""The serving load test's single modes on the port
(`python -m deeplearning4j_tpu_torch.scripts.serve_loadtest --<mode>`),
each at its `--smoke` size on the CPU: speculation and the shared
prefix, sampled speculation with the truncated drafter and the radix
cache, the request-trace plane, the alert engine, the fleet and the
replicas. Each exits 0 with every hard assert of JAX's mode held but
the `compare_bench` self-gates (they wait for the port's bench.py; the
mode says so on one line) and the replicas' scale gate (reported,
not asserted)."""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import pytest

from deeplearning4j_tpu_torch.scripts import serve_loadtest


@pytest.mark.parametrize("mode", ["--spec-smoke", "--sampled-spec-smoke",
                                  "--trace-smoke", "--alert-smoke",
                                  "--fleet-smoke", "--replica-smoke"])
def test_mode_smoke_exits_zero(mode, capfd, monkeypatch):
    # spawned replica workers inherit no thread cap
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    assert serve_loadtest.main([mode, "--device", "cpu"]) == 0
    out = capfd.readouterr().out
    if mode in ("--spec-smoke", "--sampled-spec-smoke", "--alert-smoke"):
        assert "compare_bench self-gates" in out and "not yet ported" in out
    if mode == "--replica-smoke":
        assert "reported" in out
