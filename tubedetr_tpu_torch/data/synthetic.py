"""The procedural video grounding dataset (the port's copy of ``tubedetr_tpu/data/synthetic.py``).

A bright square drifts over noise for a sub-segment of each clip, with exact
box and segment annotations in the VidSTG form, so the train, eval,
postprocess and vIoU loop runs without the VidSTG downloads. The numpy
draws are the JAX package's, so a seed gives both packages the same sample.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from tubedetr_tpu_torch.data.annotations import VideoAnnotation
from tubedetr_tpu_torch.data.collate import VideoSample
from tubedetr_tpu_torch.ops.preprocess import IMAGENET_MEAN, IMAGENET_STD


def normalize_boxes_cxcywh(boxes_xyxy: np.ndarray, h: int, w: int) -> np.ndarray:
    """xyxy pixels -> cxcywh in [0, 1]."""
    b = np.asarray(boxes_xyxy, np.float64)
    return np.stack([(b[:, 0] + b[:, 2]) / 2 / w, (b[:, 1] + b[:, 3]) / 2 / h,
                     (b[:, 2] - b[:, 0]) / w, (b[:, 3] - b[:, 1]) / h], axis=1)


def make_synthetic_sample(seed: int, t: int = 8, h: int = 64, w: int = 64,
                          video_id: str | None = None, vocab: int = 128,
                          text_len: int = 6) -> VideoSample:
    rng = np.random.RandomState(seed)
    frames = rng.randint(0, 60, size=(t, h, w, 3)).astype(np.uint8)

    start = int(rng.randint(0, t // 2))
    end = int(rng.randint(start + max(1, t // 4), t))  # inclusive
    size = int(rng.randint(h // 6, h // 3))
    boxes = np.zeros((t, 4), np.float64)
    x0, y0 = rng.randint(0, w - size), rng.randint(0, h - size)
    dx, dy = rng.randint(-3, 4), rng.randint(-3, 4)
    for i in range(start, end + 1):
        xi = int(np.clip(x0 + dx * (i - start), 0, w - size))
        yi = int(np.clip(y0 + dy * (i - start), 0, h - size))
        frames[i, yi : yi + size, xi : xi + size] = [250, 60, 60]
        boxes[i] = [xi, yi, xi + size, yi + size]

    norm = (frames.astype(np.float32) / 255.0 - np.asarray(IMAGENET_MEAN)) / np.asarray(IMAGENET_STD)
    return VideoSample(
        frames=torch.from_numpy(norm.astype(np.float32)),
        valid_hw=(h, w),
        frames_id=list(range(t)),
        video_id=video_id or f"synth{seed}",
        caption="the red square moving",
        tokens=rng.randint(2, vocab, size=(text_len,)).astype(np.int64),
        orig_size=(h, w),
        boxes_cxcywh=normalize_boxes_cxcywh(boxes, h, w).astype(np.float32),
        inter_idx=(start, end),
        qtype="declarative",
    )


def annotation_for_sample(s: VideoSample) -> VideoAnnotation:
    """The annotation that scores ``s`` in ``VIoUEvaluator`` (its boxes back
    in pixel xywh)."""
    h, w = s.orig_size
    s0, e0 = s.inter_idx
    boxes = {}
    for i in range(s0, e0 + 1):
        cx, cy, bw, bh = s.boxes_cxcywh[i]
        boxes[i] = [float((cx - bw / 2) * w), float((cy - bh / 2) * h), float(bw * w), float(bh * h)]
    return VideoAnnotation(
        video_id=s.video_id,
        frame_ids=list(s.frames_id),
        inter_frames=list(range(s0, e0 + 1)),
        tube_start_frame=s0,
        tube_end_frame=e0 + 1,
        boxes_xywh=boxes,
        caption=s.caption,
        qtype=s.qtype,
        video_path="",
        start_seconds=0.0,
        duration_seconds=max(1.0, len(s.frames_id) / 5.0),
    )


class SyntheticDataset:
    """A map-style dataset of ``n`` synthetic samples and their annotations."""

    def __init__(self, n: int = 16, t: int = 8, h: int = 64, w: int = 64,
                 seed: int = 0, vocab: int = 50265, text_len: int = 8):
        self.samples: List[VideoSample] = [
            make_synthetic_sample(seed + i, t=t, h=h, w=w, vocab=vocab, text_len=text_len)
            for i in range(n)
        ]
        self.annotations = [annotation_for_sample(s) for s in self.samples]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i: int) -> VideoSample:
        return self.samples[i]
