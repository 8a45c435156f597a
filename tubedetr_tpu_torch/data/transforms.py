"""Eval-time spatial transform and size buckets (host side).

The port's copy of the eval part of ``tubedetr_tpu/data/transforms.py``:
the DETR resize rule, the eval long-side caps, ``make_eval_transform`` and
``bucket``. The random train chain waits for the data-pipeline slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

SIZE_BUCKET = 32

# eval-time long-side cap per resolution (the ``max_size`` column of the JAX
# package's RESOLUTION_TABLES; the train chain's columns come with it later)
EVAL_MAX_SIZE = {
    128: 213, 224: 373, 256: 427, 288: 480, 320: 533, 352: 587, 384: 640,
    416: 693, 448: 746, 480: 800, 800: 1333,
}


def size_with_aspect_ratio(
    h: int, w: int, size: int, max_size: Optional[int] = None
) -> Tuple[int, int]:
    """DETR resize rule: shortest side -> ``size``, long side capped at
    ``max_size`` (aspect preserved). Returns (oh, ow)."""
    if max_size is not None:
        min_orig, max_orig = float(min(h, w)), float(max(h, w))
        if max_orig / min_orig * size > max_size:
            size = int(round(max_size * min_orig / max_orig))
    if (h <= w and h == size) or (w <= h and w == size):
        return h, w
    if h < w:
        return size, int(size * w / h)
    return int(size * h / w), size


@dataclass
class ClipTransform:
    """A fully determined spatial transform for one clip. The resize itself
    runs on the device (``ops/resize_normalize.py``) from ``out_h``/``out_w``."""

    out_h: int
    out_w: int
    boxes_xyxy: np.ndarray  # transformed boxes at output scale, (N, 4)


def make_eval_transform(h: int, w: int, boxes_xyxy: np.ndarray, resolution: int):
    """Val/test: resize the shortest side to ``resolution`` (long side capped)."""
    oh, ow = size_with_aspect_ratio(h, w, resolution, EVAL_MAX_SIZE[resolution])
    r = np.array([ow / w, oh / h, ow / w, oh / h], np.float64)
    return ClipTransform(oh, ow, boxes_xyxy * r)


def bucket(x: int, multiple: int = SIZE_BUCKET) -> int:
    return ((x + multiple - 1) // multiple) * multiple
