"""Object detection end-to-end: train a tiny YOLOv2 head on synthetic
boxes, then extract detections with get_predicted_objects + NMS.

Mirrors the reference's ObjectDetection examples (Yolo2OutputLayer's
train path and its inference extraction). Synthetic data: one bright
square per image; the network learns to put a confident box on it.
"""
import numpy as np

from deeplearning4j_tpu_torch.scripts import _common

EPOCHS = 120
N_TRAIN = 64


def make_data(n, grid=6, cell_px=8, seed=0):
    """Images [n, 48, 48, 1] with one bright square; labels
    [n, grid, grid, 4+C] in grid units (C=1 class)."""
    rng = np.random.default_rng(seed)
    H = grid * cell_px
    x = rng.normal(0.0, 0.1, (n, H, H, 1)).astype(np.float32)
    y = np.zeros((n, grid, grid, 5), np.float32)
    for i in range(n):
        gx, gy = rng.integers(1, grid - 1, 2)
        cx, cy = gx + 0.5, gy + 0.5      # box center, grid units
        w = h = 1.6
        px, py = int(cx * cell_px), int(cy * cell_px)
        half = int(w * cell_px / 2)
        x[i, py - half:py + half, px - half:px + half, 0] += 1.0
        cell = y[i, gy, gx]
        cell[0:4] = [cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2]
        cell[4] = 1.0                     # one-hot class 0
    return x, y


def main(argv=None):
    device = _common.parse_device(argv, __doc__)
    from deeplearning4j_tpu_torch.common.updaters import Adam
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import (
        ConvolutionLayer, SubsamplingLayer)
    from deeplearning4j_tpu_torch.nn.layers.objdetect import (
        Yolo2OutputLayer, non_max_suppression)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    grid, cell_px = 6, 8
    anchors = ((1.5, 1.5),)
    conf = (NeuralNetConfiguration.builder().seed(7).updater(Adam(5e-3))
            .list()
            .layer(ConvolutionLayer(n_out=16, kernel_size=(3, 3),
                                    activation="relu",
                                    convolution_mode="same"))
            .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(ConvolutionLayer(n_out=32, kernel_size=(3, 3),
                                    activation="relu",
                                    convolution_mode="same"))
            .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(ConvolutionLayer(n_out=len(anchors) * 6,
                                    kernel_size=(1, 1),
                                    activation="identity"))
            .layer(Yolo2OutputLayer(anchors=anchors))
            .set_input_type(InputType.convolutional(grid * cell_px,
                                                    grid * cell_px, 1))
            .build())
    net = MultiLayerNetwork(conf, device=device).init()

    x, y = make_data(N_TRAIN, grid, cell_px)
    print(f"training {EPOCHS} epochs on {N_TRAIN} synthetic images ...")
    net.fit(x, y, epochs=EPOCHS, batch_size=32)
    print(f"final loss {net.score_value:.4f}")

    # inference: activated output -> thresholded boxes -> NMS
    yolo = net.layers[-1]
    xt, yt = make_data(4, grid, cell_px, seed=99)
    out = net.output(xt)
    dets = non_max_suppression(
        # confidence trains toward the predicted box's IOU, so a
        # well-fit box sits at ~0.5-0.8 confidence — threshold below it
        yolo.get_predicted_objects(out, threshold=0.35), iou_threshold=0.4)
    for d in dets:
        tlx, tly = d.top_left_xy
        brx, bry = d.bottom_right_xy
        # grid units -> pixels
        print(f"example {d.example_number}: class {d.predicted_class} "
              f"conf {d.confidence:.2f} box px "
              f"({tlx * cell_px:.0f},{tly * cell_px:.0f})-"
              f"({brx * cell_px:.0f},{bry * cell_px:.0f})")
    found = {d.example_number for d in dets}
    print(f"detected objects in {len(found)}/4 held-out images")
    return dets


if __name__ == "__main__":
    main()
