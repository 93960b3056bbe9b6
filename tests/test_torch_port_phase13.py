"""Phase 13 of `chip_smoke.py` (the remaining layers, pretraining, the
frozen conv and BatchNorm) rehearsed on the CPU in its small mode. A
file of its own, so that `--dist loadfile` runs it beside the other
rehearsals."""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import torch

import chip_smoke


def test_phase_13_small_mode_on_the_cpu():
    """`chip_smoke.phase_layers_rest` at its CPU size: YOLOv2 at 1/16 of
    its widths on 64x64 images, the MoE LM at d64, MultiHeadAttention
    with n_out != n_in, VAE, DBN and AutoEncoder pretraining on a slice
    of the digits, the other new layers and a frozen conv and BatchNorm
    in training (card and CPU both the CPU here); every check passes and
    no kernel launches."""
    report, fails = {}, chip_smoke.Failures()
    launches = chip_smoke.phase_layers_rest(torch.device("cpu"), report,
                                            fails, small=True)
    assert not fails, list(fails)
    assert all(n == 0 for n in launches.values())
    r = report["layers_rest"]
    assert set(r) >= {"yolo", "moe_lm", "mha_n_out", "vae", "dbn",
                      "autoencoder", "layers", "frozen"}
    assert r["frozen"]["frozen_bit_equal"]
