"""Spatial video transforms on the host (the port's copy of ``tubedetr_tpu/data/transforms.py``).

Each clip's random train chain is sampled once, its boxes are moved with
it, and its pixel operators are composed: a resize and a crop + resize are
both separable linear maps, so the whole chain is one pair of
interpolation matrices ``(A_h, A_w)`` with ``out = A_h @ img @ A_w^T``
(``A = A3 @ A1`` for resize -> crop -> resize). The data pipeline applies
them on the host (``data/native.py``); serving reads only ``out_h`` and
``out_w`` and resizes on the card with K1 (``ops/resize_normalize.py``).

``RESOLUTION_TABLES`` are the per-resolution scales, long-side caps,
first-resize sizes and crop minima of the reference's video transforms.
The numpy draws of ``sample_train_transform`` are the JAX package's, in its
order, so one generator state gives both packages the same transform.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from tubedetr_tpu_torch.ops.preprocess import _interp_matrix

SIZE_BUCKET = 32

RESOLUTION_TABLES = {
    128: dict(scales=[96, 128], max_size=213, resizes=[80, 100, 120], crop=64),
    224: dict(scales=[128, 160, 192, 224], max_size=373, resizes=[100, 150, 200], crop=96),
    256: dict(scales=[160, 192, 224, 256], max_size=427, resizes=[140, 180, 220], crop=128),
    288: dict(scales=[160, 192, 224, 256, 288], max_size=480, resizes=[150, 200, 250], crop=128),
    320: dict(scales=[192, 224, 256, 288, 320], max_size=533, resizes=[200, 240, 280], crop=160),
    352: dict(scales=[224, 256, 288, 320, 352], max_size=587, resizes=[200, 250, 300], crop=192),
    384: dict(scales=[224, 256, 288, 320, 352, 384], max_size=640, resizes=[200, 250, 300], crop=192),
    416: dict(scales=[256, 288, 320, 352, 384, 416], max_size=693, resizes=[240, 300, 360], crop=224),
    448: dict(scales=[256, 288, 320, 352, 384, 416, 448], max_size=746, resizes=[240, 300, 360], crop=224),
    480: dict(scales=[288, 320, 352, 384, 416, 448, 480], max_size=800, resizes=[240, 300, 360], crop=240),
    800: dict(scales=[480, 512, 544, 576, 608, 640, 672, 704, 736, 768, 800],
              max_size=1333, resizes=[400, 500, 600], crop=384),
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
    """A fully determined spatial transform for one clip."""

    a_h: np.ndarray  # (out_h, in_h) composed interpolation matrix
    a_w: np.ndarray  # (out_w, in_w)
    out_h: int  # valid output extent (<= a_h.shape[0] once padded)
    out_w: int
    boxes_xyxy: np.ndarray  # transformed boxes at output scale, (N, 4)
    hflip: bool = False

    def padded(self, pad_h: int, pad_w: int) -> "ClipTransform":
        """The operator's rows zero-padded to the (pad_h, pad_w) bucket."""
        ah = np.zeros((pad_h, self.a_h.shape[1]), np.float32)
        ah[: self.a_h.shape[0]] = self.a_h
        aw = np.zeros((pad_w, self.a_w.shape[1]), np.float32)
        aw[: self.a_w.shape[0]] = self.a_w
        return ClipTransform(ah, aw, self.out_h, self.out_w, self.boxes_xyxy, self.hflip)


def _resize_boxes(boxes, h, w, oh, ow):
    return boxes * np.array([ow / w, oh / h, ow / w, oh / h], np.float64)


def _crop_boxes(boxes, top, left, ch, cw):
    out = boxes - np.array([left, top, left, top], np.float64)
    out[:, 0::2] = out[:, 0::2].clip(0, cw)
    out[:, 1::2] = out[:, 1::2].clip(0, ch)
    return out


def _boxes_alive(boxes):
    return bool(((boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])).all())


def sample_train_transform(
    rng: np.random.Generator,
    h: int,
    w: int,
    boxes_xyxy: np.ndarray,
    resolution: int = 224,
    respect_boxes: bool = True,
    allow_hflip: bool = False,
) -> ClipTransform:
    """The reference train chain: with p=0.5 a multi-scale resize, else a
    resize -> ``RandomSizeCrop`` that keeps every box alive (up to 100
    tries; the uncropped clip when none does) -> multi-scale resize."""
    tbl = RESOLUTION_TABLES[resolution]
    hflip = bool(allow_hflip and rng.random() < 0.5)
    if hflip:
        flipped = boxes_xyxy.copy()
        flipped[:, 0] = w - boxes_xyxy[:, 2]
        flipped[:, 2] = w - boxes_xyxy[:, 0]
        boxes_xyxy = flipped

    if rng.random() < 0.5:
        size = int(rng.choice(tbl["scales"]))
        oh, ow = size_with_aspect_ratio(h, w, size, tbl["max_size"])
        ct = ClipTransform(_interp_matrix(h, oh), _interp_matrix(w, ow), oh, ow,
                           _resize_boxes(boxes_xyxy, h, w, oh, ow), hflip)
    else:
        size1 = int(rng.choice(tbl["resizes"]))
        oh1, ow1 = size_with_aspect_ratio(h, w, size1, None)
        boxes1 = _resize_boxes(boxes_xyxy, h, w, oh1, ow1)
        crop = None
        for _ in range(100):
            tw = int(rng.integers(tbl["crop"], min(ow1, tbl["max_size"]) + 1))
            th = int(rng.integers(tbl["crop"], min(oh1, tbl["max_size"]) + 1))
            top = int(rng.integers(0, oh1 - th + 1))
            left = int(rng.integers(0, ow1 - tw + 1))
            cand = _crop_boxes(boxes1, top, left, th, tw)
            if not respect_boxes or _boxes_alive(cand) or len(cand) == 0:
                crop = (top, left, th, tw, cand)
                break
        top, left, th, tw, boxes2 = crop if crop is not None else (0, 0, oh1, ow1, boxes1)
        size3 = int(rng.choice(tbl["scales"]))
        oh3, ow3 = size_with_aspect_ratio(th, tw, size3, tbl["max_size"])
        ah3 = _interp_matrix(oh1, oh3, float(top), float(th))
        aw3 = _interp_matrix(ow1, ow3, float(left), float(tw))
        # out = A3 @ (A1 @ img): one operator A3 @ A1
        ct = ClipTransform(
            (ah3 @ _interp_matrix(h, oh1)).astype(np.float32),
            (aw3 @ _interp_matrix(w, ow1)).astype(np.float32),
            oh3, ow3, _resize_boxes(boxes2, th, tw, oh3, ow3), hflip,
        )
    if hflip:  # the box math above already worked in flipped coordinates
        ct = ClipTransform(ct.a_h, ct.a_w[:, ::-1].copy(), ct.out_h, ct.out_w,
                           ct.boxes_xyxy, True)
    return ct


def make_eval_transform(h: int, w: int, boxes_xyxy: np.ndarray, resolution: int):
    """Val/test: resize the shortest side to ``resolution`` (long side capped)."""
    oh, ow = size_with_aspect_ratio(h, w, resolution, RESOLUTION_TABLES[resolution]["max_size"])
    return ClipTransform(_interp_matrix(h, oh), _interp_matrix(w, ow), oh, ow,
                         _resize_boxes(boxes_xyxy, h, w, oh, ow), False)


def bucket(x: int, multiple: int = SIZE_BUCKET) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def hflip_caption(caption: str) -> str:
    """Swap the words 'left' and 'right' of a horizontally flipped clip's caption."""
    out = []
    for w in caption.split():
        core = w.strip(".,!?;:")
        if core == "left":
            out.append(w.replace("left", "right"))
        elif core == "right":
            out.append(w.replace("right", "left"))
        else:
            out.append(w)
    return " ".join(out)


def normalize_boxes_cxcywh(boxes_xyxy: np.ndarray, h: int, w: int) -> np.ndarray:
    """xyxy pixels -> cxcywh in [0, 1]."""
    b = np.asarray(boxes_xyxy, np.float64)
    return np.stack([(b[:, 0] + b[:, 2]) / 2 / w, (b[:, 1] + b[:, 3]) / 2 / h,
                     (b[:, 2] - b[:, 0]) / w, (b[:, 3] - b[:, 1]) / h], axis=1)


def prepare_boxes(raw_boxes_xywh: np.ndarray, h: int, w: int) -> np.ndarray:
    """Annotation xywh -> xyxy clamped to the frame. A degenerate box stays
    (zero area); the loss's moment mask leaves it out."""
    b = np.asarray(raw_boxes_xywh, np.float64).reshape(-1, 4).copy()
    b[:, 2:] += b[:, :2]
    b[:, 0::2] = b[:, 0::2].clip(0, w)
    b[:, 1::2] = b[:, 1::2].clip(0, h)
    return b
