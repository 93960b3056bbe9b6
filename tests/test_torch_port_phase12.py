"""Phase 12 of `chip_smoke.py` (the CNN zoo) rehearsed on the CPU in its
small mode. A file of its own, so that `--dist loadfile` runs it
beside the other rehearsals."""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import torch

import chip_smoke


def test_phase_12_small_mode_on_the_cpu():
    """`chip_smoke.phase_cnn_zoo` at its CPU size: the packaged LeNet on
    the digits (card and CPU both the CPU here) and its twins, GoogLeNet,
    VGG16 and the five other CNNs at reduced input sizes, the bf16
    bounds; every check passes and no kernel launches."""
    report, fails = {}, chip_smoke.Failures()
    launches = chip_smoke.phase_cnn_zoo(torch.device("cpu"), report, fails,
                                        small=True)
    assert not fails, list(fails)
    assert all(n == 0 for n in launches.values())
    r = report["cnn_zoo"]
    assert r["lenet"]["accuracy_cpu"] == 290 / 297
    assert set(r) >= {"GoogLeNet", "VGG16", "AlexNet", "SimpleCNN", "VGG19",
                      "InceptionResNetV1", "FaceNetNN4Small2", "bounds"}
