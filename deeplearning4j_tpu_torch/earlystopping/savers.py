"""Model savers (counterpart of
`deeplearning4j_tpu/earlystopping/savers.py`): in memory (`copy()`, its
own tensors) and to local files through the zip (`util/serializer`),
restored on the saver's `device`."""

from __future__ import annotations

from pathlib import Path

from deeplearning4j_tpu_torch.util.serializer import ModelSerializer


class InMemoryModelSaver:
    def __init__(self):
        self._best = None
        self._latest = None

    def save_best_model(self, model, score):
        self._best = model.copy()

    def save_latest_model(self, model, score):
        self._latest = model.copy()

    def get_best_model(self):
        return self._best

    def get_latest_model(self):
        return self._latest


class LocalFileModelSaver:
    def __init__(self, directory, *, device="cuda"):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.device = device

    @property
    def best_path(self):
        return self.directory / "bestModel.zip"

    @property
    def latest_path(self):
        return self.directory / "latestModel.zip"

    def save_best_model(self, model, score):
        ModelSerializer.write_model(model, self.best_path)

    def save_latest_model(self, model, score):
        ModelSerializer.write_model(model, self.latest_path)

    def get_best_model(self):
        return ModelSerializer.restore_model(self.best_path,
                                             device=self.device)

    def get_latest_model(self):
        return ModelSerializer.restore_model(self.latest_path,
                                             device=self.device)
