"""The bridge fixtures (tests/fixtures/bridge/) against the JAX package
that writes them, and the port against the fixtures, on the CPU.

- Regenerating every fixture in a temporary directory with
  `tests/fixtures/make_bridge_fixtures.py` gives equal configurations,
  keys and counters, and arrays and a golden equal up to XLA:CPU's
  rounding on the machine at hand (ARRAY_RTOL, GOLDEN_TOL below), so
  the committed files cannot drift from what the JAX package writes.
- The port builds the smoke LM from the JAX `configuration.json` files
  (fp32 and mixed_bf16) and writes the same text back.
- Phase 7 (d) of `chip_smoke.py` passes on the CPU: the JAX zip restored
  in the port reproduces JAX's `output()` (OUTPUT_ATOL 1e-4), greedy
  tokens and next `fit` step (`check_jax_fixture`).
"""

import importlib.util
import io
import json
import os
import zipfile

import numpy as np
import pytest
import torch

import chip_smoke
from deeplearning4j_tpu_torch.nn.conf.builder import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.zoo.transformer import TransformerLM

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
HERE = os.path.join(FIXTURES, "bridge")
_spec = importlib.util.spec_from_file_location(
    "make_bridge_fixtures", os.path.join(FIXTURES, "make_bridge_fixtures.py"))
fixtures = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fixtures)
# Regenerated on another CPU the JAX package's numbers may differ in the
# last bits: XLA:CPU compiles for the host's instruction set (the JAX
# package's own `test_kernels.py::TestFusedAdamKernel::
# test_bit_parity_vs_jnp_path` passes on one machine and fails on
# another). So configurations, keys, shapes, dtypes, counters and ids
# must be equal, and floats close: arrays to ARRAY_RTOL in relative
# Frobenius norm, the golden's probabilities and loss to GOLDEN_TOL, its
# leaf sums to ARRAY_RTOL of the leaf's norm. Each block's `attn_bk` is
# the exception: its gradient is rounding noise, which Adam turns into
# steps of up to `adam_step_max()` each on either machine, so the param
# is held to that bound and its Adam slots (noise) are not compared.
ARRAY_RTOL = 1e-4
GOLDEN_TOL = 1e-6
BK_STEP = chip_smoke.adam_step_max()


def _zip_contents(path):
    with zipfile.ZipFile(path) as zf:
        arrays = {n: dict(np.load(io.BytesIO(zf.read(n))))
                  for n in zf.namelist() if n.endswith(".npz")}
        return (json.loads(zf.read("configuration.json")),
                json.loads(zf.read("meta.json")), arrays)


def _assert_arrays_close(key, got, want, steps):
    assert got.shape == want.shape and got.dtype == want.dtype, key
    if "attn_bk" in key:
        if "__" not in key:                     # the param, not a slot
            assert np.abs(got - want).max() <= 2 * steps * BK_STEP, key
        return
    scale = np.linalg.norm(want)
    assert np.linalg.norm(got - want) <= ARRAY_RTOL * scale, key


def test_regenerated_fixtures_match_the_committed_ones(tmp_path):
    fixtures.make(str(tmp_path))
    for name in ("lm_config.json", "lm_config_mixed_bf16.json"):
        with open(os.path.join(HERE, name)) as a, open(tmp_path / name) as b:
            assert a.read() == b.read(), name
    conf, meta, arrays = _zip_contents(os.path.join(HERE, "lm_small.zip"))
    conf2, meta2, arrays2 = _zip_contents(tmp_path / "lm_small.zip")
    assert conf == conf2
    assert meta.keys() == meta2.keys()
    assert {k: v for k, v in meta.items() if k != "array_checksums"} == \
        {k: v for k, v in meta2.items() if k != "array_checksums"}
    assert meta["array_checksums"].keys() == meta2["array_checksums"].keys()
    assert arrays.keys() == arrays2.keys()
    for member, arrs in arrays.items():
        assert arrs.keys() == arrays2[member].keys()
        for k, a in arrs.items():
            _assert_arrays_close(k, arrays2[member][k], a, fixtures.STEPS)
    g, g2 = (np.load(p) for p in (os.path.join(HERE, "lm_small_golden.npz"),
                                  tmp_path / "lm_small_golden.npz"))
    assert set(g.files) == set(g2.files)
    steps = fixtures.STEPS + 1
    for k in g.files:
        got, want = g2[k], g[k]
        if want.dtype.kind in "iu" or k in ("step_x",):
            np.testing.assert_array_equal(got, want, err_msg=k)
        elif k.startswith(("sum/", "sumsq/")):
            leaf = k.split("/", 1)[1]
            ss = float(g[f"sumsq/{leaf}"])
            n = arrays["params.npz"][leaf.replace("/", "::")].size
            if leaf.endswith("attn_bk"):
                # every element at most 2 * steps * BK_STEP away
                d = 2 * steps * BK_STEP
                tol = n * d if k.startswith("sum/") else d * (
                    2 * np.sqrt(n * ss) + n * d)
            else:
                tol = ARRAY_RTOL * (np.sqrt(n * ss) if k.startswith("sum/")
                                    else ss)
            assert abs(float(got) - float(want)) <= tol, k
        else:
            np.testing.assert_allclose(got, want, rtol=GOLDEN_TOL,
                                       atol=GOLDEN_TOL, err_msg=k)
    assert os.path.getsize(os.path.join(HERE, "lm_small.zip")) < 2 * 2 ** 20


@pytest.mark.parametrize("name,policy", [("lm_config.json", "float32"),
                                         ("lm_config_mixed_bf16.json",
                                          "mixed_bf16")])
def test_port_builds_the_smoke_lm_from_the_jax_configuration(name, policy):
    with open(os.path.join(HERE, name)) as f:
        text = f.read()
    conf = MultiLayerConfiguration.from_json(text)
    assert conf.to_json(indent=2) == text
    net = MultiLayerNetwork(conf, device="cpu")
    assert net.dtype.name == policy
    assert net.layers[0].n_in == 512 and net.layers[0].time_series_input
    mine = TransformerLM(512, d_model=256, n_layers=4, n_heads=8,
                         max_len=512).conf()
    if policy != "float32":
        mine.dtype_policy = policy
    assert mine.to_json(indent=2) == text


def test_jax_fixture_zip_reproduces_jax_in_the_port():
    fails = chip_smoke.Failures()
    row, launches = chip_smoke.check_jax_fixture(torch.device("cpu"), fails)
    assert not fails, list(fails)
    assert row["tokens_equal"] and all(n == 0 for n in launches.values())
