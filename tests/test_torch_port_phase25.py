"""Phase 25 of `chip_smoke.py` (the training UI watching the smoke LM:
reports card against CPU, the listener's cost, the dashboard's routes,
the conv-activation grids, the serving and t-SNE pages) rehearsed on the
CPU in its small mode, and the script's PNG reader. A file of its own,
so that `--dist loadfile` runs it beside the other rehearsals."""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import numpy as np
import pytest
import torch

import chip_smoke
from deeplearning4j_tpu_torch.ui.convolutional import png_gray


def test_phase_25_small_mode_on_the_cpu():
    """Every check passes; with both sides on the CPU step 0's report
    equals the "card's" exactly, and no hand-written kernel launches."""
    report, fails = {}, chip_smoke.Failures()
    launches = chip_smoke.phase_ui(torch.device("cpu"), report, fails,
                                   small=True)
    assert not fails, list(fails)
    assert not any(launches.values())
    assert set(launches) == set(chip_smoke.KERNEL_META)
    r = report["ui"]
    a = r["a"]
    assert a["iterations"] == list(range(chip_smoke.UI_SMALL["steps"]))
    assert set(a["step0_rel"].values()) == {0.0}
    assert a["step0_hist_moved"] == 0 and a["reopened_equal"]
    assert a["training_iterations_total"] == chip_smoke.UI_SMALL["steps"]
    b = r["b"]
    assert set(b) == {"off", "memory", "file", "report_bytes"}
    assert b["report_bytes"]["file"] > b["report_bytes"]["memory"] > 0
    c = r["c"]
    assert all(p["code"] == 200 for p in c["pages"].values())
    assert c["api_iterations"] == a["iterations"]
    assert c["remote_equal"] and not c["profile"]["tpu_on_page"]
    assert all(c["metrics_families"].values())
    d = r["d"]
    assert d["max_gray_diff"] == 0 and d["png_equal"] and d["served"]
    assert d["names"] == ["layer0", "layer1", "layer2", "layer3"]
    e = r["e"]
    small = chip_smoke.UI_SMALL
    assert e["requests"] == small["requests"]
    assert e["tokens"] == small["requests"] * small["tokens"]
    assert e["tsne"]["circles"] == e["tsne"]["points"] == 1032


def test_phase_25_takes_phase_23s_map():
    """A map handed in (as `run` hands phase 23's) is the one drawn."""
    report, fails = {}, chip_smoke.Failures()
    coords = np.random.default_rng(0).standard_normal((7, 2))
    chip_smoke.phase_ui(torch.device("cpu"), report, fails, small=True,
                        tsne=(coords, "phase 23 (b) (ii), test"))
    assert not fails, list(fails)
    assert report["ui"]["e"]["tsne"] == dict(
        source="phase 23 (b) (ii), test", points=7, circles=7)


@pytest.mark.parametrize("shape", [(1, 1), (5, 3), (40, 17)])
def test_png_pixels_reads_the_ports_png(shape):
    grid = np.random.default_rng(shape[1]).integers(
        0, 256, shape).astype(np.uint8)
    np.testing.assert_array_equal(chip_smoke.png_pixels(png_gray(grid)),
                                  grid)
    with pytest.raises(ValueError):
        chip_smoke.png_pixels(b"not a png at all")


def test_ui_flag_needs_a_card():
    """`--ui` runs phase 25 alone on a card; without CUDA the script
    exits 2 before any phase."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the exit path is not taken")
    assert chip_smoke.main(["--ui"]) == 2
