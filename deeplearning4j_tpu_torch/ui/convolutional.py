"""ConvolutionalIterationListener — render conv activations as image
grids (counterpart of `deeplearning4j_tpu/ui/convolutional.py`).

Reference: `ui/ConvolutionalIterationListener.java` (621 LoC): every N
iterations, run the current minibatch's first example through the
network and save each convolutional layer's activation channels as one
tiled grayscale image.

The activations come from the port's `MultiLayerNetwork.feed_forward`
(no grad, NHWC as JAX's are): each 4-D layer's first example [H, W, C]
is brought to the host in one batched copy. The PNGs are written with
the standard library (`png_gray`), so no imaging package is needed.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener


def activations_to_grid(act: np.ndarray, pad: int = 1) -> np.ndarray:
    """[H, W, C] activations → one tiled uint8 grayscale image."""
    h, w, c = act.shape
    cols = int(np.ceil(np.sqrt(c)))
    rows = int(np.ceil(c / cols))
    grid = np.zeros((rows * (h + pad) - pad, cols * (w + pad) - pad),
                    np.float32)
    for i in range(c):
        r, col = divmod(i, cols)
        ch = act[:, :, i]
        lo, hi = float(ch.min()), float(ch.max())
        norm = (ch - lo) / (hi - lo) if hi > lo else np.zeros_like(ch)
        grid[r * (h + pad):r * (h + pad) + h,
             col * (w + pad):col * (w + pad) + w] = norm
    return (grid * 255).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def png_gray(grid) -> bytes:
    """A [H, W] uint8 array as an 8-bit grayscale PNG (each scanline
    unfiltered, the whole image one zlib stream)."""
    img = np.ascontiguousarray(np.asarray(grid, np.uint8))
    if img.ndim != 2:
        raise ValueError(f"a grayscale grid is [H, W], got {img.shape}")
    h, w = img.shape
    raw = np.zeros((h, w + 1), np.uint8)     # filter byte 0 a row
    raw[:, 1:] = img
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


class ConvolutionalIterationListener(TrainingListener):
    def __init__(self, output_dir=None, frequency: int = 10, ui_server=None):
        """`output_dir`: save tiled grids as PNG files; `ui_server`:
        also feed the UIServer's /activations module (reference play
        `module/convolutional/`). At least one sink must be given."""
        if output_dir is None and ui_server is None:
            raise ValueError("need output_dir and/or ui_server")
        self.output_dir = None if output_dir is None else Path(output_dir)
        if self.output_dir is not None:
            self.output_dir.mkdir(parents=True, exist_ok=True)
        self.ui_server = ui_server
        self.frequency = max(1, frequency)

    def iteration_done(self, model, iteration, epoch, score, **info):
        if iteration % self.frequency != 0:
            return
        batch = info.get("batch")
        if batch is None:
            return
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
        # JAX's listener reaches `_forward_core`, which only its
        # MultiLayerNetwork has; any other model yields no grid. The
        # check is made here, and a failed forward raises
        if not isinstance(model, MultiLayerNetwork):
            return
        from deeplearning4j_tpu_torch.monitor.diagnostics import (
            batched_host_tree)
        acts = model.feed_forward(batch[0][:1])   # first example only
        # NHWC conv activations only, every one in ONE host copy
        firsts = batched_host_tree({str(li): act[0].float()
                                    for li, act in enumerate(acts)
                                    if act.ndim == 4})
        for li in range(len(acts)):
            a = firsts.get(str(li))
            if a is None:
                continue
            grid = activations_to_grid(a)
            if self.output_dir is not None:
                (self.output_dir / f"iter{iteration:06d}_layer{li}.png"
                 ).write_bytes(png_gray(grid))
            if self.ui_server is not None:
                self.ui_server.post_activation_grid(f"layer{li}", grid)
