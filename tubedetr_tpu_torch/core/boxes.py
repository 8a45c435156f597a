"""Bounding-box utilities on tensors and in numpy (counterpart of ``tubedetr_tpu/core/boxes.py``).

The tensor functions are elementwise over ``[..., 4]`` xyxy boxes (paired
IoU and GIoU, the diagonal a loss consumes); the numpy ones serve the
host-side evaluator (pairwise ``N x M`` IoU).
"""

from __future__ import annotations

import numpy as np
import torch


def box_cxcywh_to_xyxy(x: torch.Tensor) -> torch.Tensor:
    xc, yc, w, h = x.unbind(-1)
    return torch.stack(
        [xc - 0.5 * w, yc - 0.5 * h, xc + 0.5 * w, yc + 0.5 * h], dim=-1
    )


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of ``[..., 4]`` xyxy boxes."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def paired_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """Elementwise IoU of two ``[..., 4]`` xyxy box tensors: (iou, union)."""
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(boxes1) + box_area(boxes2) - inter
    return inter / union, union


def paired_generalized_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Elementwise GIoU of ``[..., 4]`` xyxy boxes. Degenerate boxes
    (x1 < x0) are the caller's to avoid; sigmoid cxcywh predictions never
    make one."""
    iou, union = paired_box_iou(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0)
    area = wh[..., 0] * wh[..., 1]
    return iou - (area - union) / area


def np_box_area(boxes: np.ndarray) -> np.ndarray:
    assert boxes.ndim == 2 and boxes.shape[-1] == 4
    return (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])


def np_box_iou(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """Pairwise ``N x M`` IoU of xyxy boxes."""
    area1 = np_box_area(boxes1)
    area2 = np_box_area(boxes2)
    lt = np.maximum(boxes1[:, None, :2], boxes2[:, :2])
    rb = np.minimum(boxes1[:, None, 2:], boxes2[:, 2:])
    wh = (rb - lt).clip(min=0)
    inter = wh[:, :, 0] * wh[:, :, 1]
    union = area1[:, None] + area2 - inter
    return inter / union
