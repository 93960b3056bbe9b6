"""YOLOv2 output layer (counterpart of
`deeplearning4j_tpu/nn/layers/objdetect.py`: `DetectedObject` :36,
`iou_xyxy` :74, `non_max_suppression` :84, `Yolo2OutputLayer` :112-265).

Layouts are NHWC: activations [B, H, W, A*(5+C)], labels [B, H, W, 4+C]
with the box as (x1, y1, x2, y2) in grid units and a one-hot class
vector that is all zero for an empty cell.

`forward` activates the raw map: sigmoid on (tx, ty) plus the cell's
offset, anchors * exp on (tw, th), sigmoid on the confidence, softmax
over the classes, concatenated back to [B, H, W, A*(5+C)].
`compute_loss` picks the responsible anchor of each cell by the first
maximum of its IoU with the truth, weighs the position loss on (x, y)
and on sqrt(w), sqrt(h) by `lambda_coord`, takes the IoU (gradient
stopped) as the confidence target and `lambda_no_obj` for the other
anchors, adds the class cross-entropy, and divides the sum by the batch.
`get_predicted_objects`, `get_confidence_matrix` and
`get_probability_matrix` read an activated output on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer
from deeplearning4j_tpu_torch.nn.layers.feedforward import (
    BaseOutputLayerMixin,
)


@dataclasses.dataclass
class DetectedObject:
    """One detected object in grid-cell units: the example's index in
    its minibatch, the center, the size, the class probabilities and the
    confidence."""

    example_number: int
    center_x: float
    center_y: float
    width: float
    height: float
    class_predictions: Any
    confidence: float

    @property
    def top_left_xy(self):
        return (self.center_x - self.width / 2.0,
                self.center_y - self.height / 2.0)

    @property
    def bottom_right_xy(self):
        return (self.center_x + self.width / 2.0,
                self.center_y + self.height / 2.0)

    @property
    def predicted_class(self) -> int:
        return int(np.argmax(np.asarray(self.class_predictions)))


def iou_xyxy(a, b):
    """IoU of two (x1, y1, x2, y2) boxes (host floats)."""
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    area_a = max(0.0, a[2] - a[0]) * max(0.0, a[3] - a[1])
    area_b = max(0.0, b[2] - b[0]) * max(0.0, b[3] - b[1])
    return inter / (area_a + area_b - inter + 1e-9)


def non_max_suppression(objects, iou_threshold=0.45):
    """Greedy per-class NMS over `DetectedObject`s: objects of different
    examples or predicted classes never suppress each other. Survivors
    by descending confidence."""
    remaining = sorted(objects, key=lambda o: -o.confidence)
    out = []
    while remaining:
        best = remaining.pop(0)
        out.append(best)
        bb = best.top_left_xy + best.bottom_right_xy
        key = (best.example_number, best.predicted_class)
        kept = []
        for o in remaining:
            if (o.example_number, o.predicted_class) == key and iou_xyxy(
                    bb, o.top_left_xy + o.bottom_right_xy) >= iou_threshold:
                continue
            kept.append(o)
        remaining = kept
    return out


def _host(a) -> np.ndarray:
    return (a.detach().float().cpu().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a))


@register_layer
class Yolo2OutputLayer(Layer, BaseOutputLayerMixin):
    layer_name = "yolo2_output"
    FIELDS = (("anchors", ((1.0, 1.0),)), ("lambda_coord", 5.0),
              ("lambda_no_obj", 0.5))
    DEFAULT_ACTIVATION = "identity"

    def __init__(self, **config):
        super().__init__(**config)
        self.anchors = tuple(tuple(float(v) for v in a) for a in self.anchors)

    @property
    def n_anchors(self):
        return len(self.anchors)

    def get_output_type(self, input_type):
        return input_type

    def _split(self, x):
        """[B, H, W, A*(5+C)] -> xy [B, H, W, A, 2], wh, conf [B, H, W, A],
        classes [B, H, W, A, C]."""
        b, h, w, d = x.shape
        x = x.reshape(b, h, w, self.n_anchors, d // self.n_anchors)
        return x[..., 0:2], x[..., 2:4], x[..., 4], x[..., 5:]

    def _pred_boxes(self, txy, twh):
        """(center, size) in grid units; the anchors in txy's dtype."""
        h, w = txy.shape[1], txy.shape[2]
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=txy.dtype, device=txy.device),
            torch.arange(w, dtype=txy.dtype, device=txy.device),
            indexing="ij")
        grid = torch.stack([gx, gy], dim=-1)[None, :, :, None, :]
        anchors = torch.tensor(self.anchors, dtype=txy.dtype,
                               device=txy.device)[None, None, None]
        return torch.sigmoid(txy) + grid, anchors * torch.exp(twh)

    @staticmethod
    def _iou(cxy, wh, gt_cxy, gt_wh):
        p1, p2 = cxy - wh / 2.0, cxy + wh / 2.0
        g1, g2 = gt_cxy - gt_wh / 2.0, gt_cxy + gt_wh / 2.0
        inter = (torch.minimum(p2, g2) - torch.maximum(p1, g1)).clamp(
            min=0.0).prod(dim=-1)
        area_p = (p2 - p1).clamp(min=0.0).prod(dim=-1)
        area_g = (g2 - g1).clamp(min=0.0).prod(dim=-1)
        return inter / (area_p + area_g - inter + 1e-9)

    def forward(self, x, *, train=False, rng=None, mask=None):
        txy, twh, tconf, tcls = self._split(x)
        cxy, wh = self._pred_boxes(txy, twh)
        out = torch.cat([cxy, wh, torch.sigmoid(tconf)[..., None],
                         torch.softmax(tcls, dim=-1)], dim=-1)
        return out.reshape(x.shape[0], x.shape[1], x.shape[2], -1)

    def pre_output(self, x):
        return x

    def compute_loss(self, x, labels, mask=None, *, train=False, rng=None):
        txy, twh, tconf, tcls = self._split(x)
        cxy, wh = self._pred_boxes(txy, twh)
        gt_box, gt_cls = labels[..., 0:4], labels[..., 4:]
        obj_cell = (gt_cls.sum(dim=-1) > 0).to(x.dtype)
        gt_cxy = (gt_box[..., 0:2] + gt_box[..., 2:4]) / 2.0
        gt_wh = (gt_box[..., 2:4] - gt_box[..., 0:2]).clamp(min=1e-6)
        iou = self._iou(cxy, wh, gt_cxy[:, :, :, None], gt_wh[:, :, :, None])
        responsible = F.one_hot(iou.argmax(dim=-1),
                                self.n_anchors).to(x.dtype)
        obj_mask = responsible * obj_cell[..., None]
        noobj_mask = 1.0 - obj_mask
        gt_off = gt_cxy - torch.floor(gt_cxy)
        pos_xy = ((torch.sigmoid(txy) - gt_off[:, :, :, None]) ** 2).sum(-1)
        pos_wh = ((torch.sqrt(wh + 1e-9)
                   - torch.sqrt(gt_wh[:, :, :, None] + 1e-9)) ** 2).sum(-1)
        pos_loss = self.lambda_coord * (obj_mask * (pos_xy + pos_wh)).sum()
        conf = torch.sigmoid(tconf)
        conf_loss = (obj_mask * (conf - iou.detach()) ** 2).sum() \
            + self.lambda_no_obj * (noobj_mask * conf ** 2).sum()
        ce = -(gt_cls[:, :, :, None] * torch.log_softmax(tcls, dim=-1)).sum(-1)
        cls_loss = (obj_mask * ce).sum()
        return (pos_loss + conf_loss + cls_loss) / x.shape[0]

    # ------------------------------------------------------- host readers
    def _grid(self, activated_output):
        out = _host(activated_output)
        b, h, w, d = out.shape
        return out.reshape(b, h, w, self.n_anchors, d // self.n_anchors)

    def get_predicted_objects(self, activated_output, threshold):
        """The detections of a `forward()` output (a tensor or an array,
        [B, H, W, A*(5+C)], centers already offset by their cell) whose
        confidence is at least `threshold`, in grid units."""
        out = _host(activated_output)
        if out.ndim != 4:
            raise ValueError(
                "Invalid network output activations array: should be rank 4 "
                f"[B, H, W, A*(5+C)]. Got shape {out.shape}")
        if not 0.0 <= float(threshold) <= 1.0:
            raise ValueError(
                f"Invalid threshold: must be in range [0,1]. Got: {threshold}")
        d, a = out.shape[-1], self.n_anchors
        if d // a < 5 or d % a:
            raise ValueError(f"Output depth {d} incompatible with {a} "
                             f"anchors: need A*(5+C) channels")
        grid = self._grid(out)
        conf = grid[..., 4]
        detections = []
        for (i, y, x, box) in np.argwhere(conf >= float(threshold)):
            cell = grid[i, y, x, box]
            detections.append(DetectedObject(
                example_number=int(i), center_x=float(cell[0]),
                center_y=float(cell[1]), width=float(cell[2]),
                height=float(cell[3]), class_predictions=np.array(cell[5:]),
                confidence=float(conf[i, y, x, box])))
        return detections

    def get_confidence_matrix(self, activated_output, example, anchor):
        """[H, W] confidence of one example and anchor."""
        return self._grid(activated_output)[example, :, :, anchor, 4]

    def get_probability_matrix(self, activated_output, example,
                               class_number):
        """[H, W] probability of one class, the largest over anchors."""
        return self._grid(activated_output)[
            example, :, :, :, 5 + class_number].max(axis=-1)
