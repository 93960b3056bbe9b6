"""The port's examples (`deeplearning4j_tpu_torch/examples/`), each
`main(["--device", "cpu"])` run on the CPU at cut sizes (its
module-level constants shortened, as phase 26 of `chip_smoke.py` cuts
them on the card): each finishes and returns what it printed about.
Each defaults to the card and raises without CUDA."""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import importlib

import numpy as np
import pytest
import torch

# the cuts: epochs, steps and data sizes only
CUTS = {
    "char_lstm": dict(EPOCHS=1, SAMPLE_CHARS=10),
    "chinese_word2vec": dict(EPOCHS=1),
    "word2vec_basic": dict(EPOCHS=1),
    "distributed_training": dict(EPOCHS=2),
    "keras_import_pretrained": dict(FINETUNE_EPOCHS=1, N_EVAL=64),
    "long_context": dict(EPOCHS=1),
    "mnist_cnn": dict(N_TRAIN=256, N_TEST=256, EPOCHS=1),
    "object_detection": dict(EPOCHS=2, N_TRAIN=32),
    "training_diagnostics": dict(EPOCHS=1),
    "transfer_and_serve": dict(BASE_EPOCHS=2, TUNE_EPOCHS=1),
    "transformer_generate": dict(EPOCHS=1, SAMPLE_TOKENS=4, BEAM_TOKENS=4),
    "transformer_text": dict(EPOCHS=1, N_EXAMPLES=128),
}


def _example(name, monkeypatch):
    mod = importlib.import_module(f"deeplearning4j_tpu_torch.examples.{name}")
    for k, v in CUTS[name].items():
        assert hasattr(mod, k), (name, k)
        monkeypatch.setattr(mod, k, v)
    return mod


def test_every_example_is_listed():
    import pkgutil
    import deeplearning4j_tpu_torch.examples as ex
    names = sorted(m.name for m in pkgutil.iter_modules(ex.__path__))
    assert names == sorted(CUTS) and len(names) == 12


@pytest.mark.parametrize("name", sorted(CUTS))
def test_example_runs_on_the_cpu(name, monkeypatch, capsys):
    mod = _example(name, monkeypatch)
    out = mod.main(["--device", "cpu"])
    printed = capsys.readouterr().out
    assert out is not None and printed.strip()
    if name == "transformer_text":
        assert 0.0 <= out <= 1.0
    if name == "char_lstm":
        assert len(out) == CUTS[name]["SAMPLE_CHARS"] + 1
    if name == "keras_import_pretrained":
        imported, ev = out
        assert "libhdf5:" in printed and ev.accuracy() > 0.9
    if name == "transfer_and_serve":
        assert out.shape == (5,)
    if name == "transformer_generate":
        tokens, beams = out
        assert np.asarray(tokens).shape == (1, 4)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("name", sorted(CUTS))
def test_example_raises_without_cuda(name):
    mod = importlib.import_module(f"deeplearning4j_tpu_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main([])
