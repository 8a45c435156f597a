"""The procedural video grounding dataset (the port's copy of ``tubedetr_tpu/data/synthetic.py``).

A bright square drifts over noise for a sub-segment of each clip, with exact
box and segment annotations in the VidSTG form, so the train, eval,
postprocess and vIoU loop runs without the VidSTG downloads. The numpy
draws are the JAX package's, so a seed gives both packages the same sample.
``write_vidstg_dir`` writes such videos to disk in the VidSTG layout
(annotation files and uint8 ``.npy`` clips), for the whole data pipeline.
"""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np
import torch

from tubedetr_tpu_torch.data.annotations import VideoAnnotation
from tubedetr_tpu_torch.data.collate import VideoSample
from tubedetr_tpu_torch.data.transforms import normalize_boxes_cxcywh
from tubedetr_tpu_torch.ops.preprocess import IMAGENET_MEAN, IMAGENET_STD


def _paint_square(rng: np.random.RandomState, frames: np.ndarray):
    """Draw a segment and a square drifting over it, paint the square into
    the uint8 ``frames`` (t, h, w, 3) in place; ``(start, end, xyxy boxes
    (t, 4), zeros outside [start, end])``, ``end`` inclusive."""
    t, h, w = frames.shape[:3]
    start = int(rng.randint(0, t // 2))
    end = int(rng.randint(start + max(1, t // 4), t))
    size = int(rng.randint(h // 6, h // 3))
    boxes = np.zeros((t, 4), np.float64)
    x0, y0 = rng.randint(0, w - size), rng.randint(0, h - size)
    dx, dy = rng.randint(-3, 4), rng.randint(-3, 4)
    for i in range(start, end + 1):
        xi = int(np.clip(x0 + dx * (i - start), 0, w - size))
        yi = int(np.clip(y0 + dy * (i - start), 0, h - size))
        frames[i, yi : yi + size, xi : xi + size] = [250, 60, 60]
        boxes[i] = [xi, yi, xi + size, yi + size]
    return start, end, boxes


def make_synthetic_sample(seed: int, t: int = 8, h: int = 64, w: int = 64,
                          video_id: str | None = None, vocab: int = 128,
                          text_len: int = 6) -> VideoSample:
    rng = np.random.RandomState(seed)
    frames = rng.randint(0, 60, size=(t, h, w, 3)).astype(np.uint8)
    start, end, boxes = _paint_square(rng, frames)
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


def make_synthetic_batch_samples(n: int, seed0: int = 0, **kw) -> List[VideoSample]:
    """``n`` samples of seeds ``seed0, seed0 + 1, ...``."""
    return [make_synthetic_sample(seed0 + i, **kw) for i in range(n)]


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


def synthetic_clip(seed: int, t: int, h: int, w: int):
    """A uint8 (t, h, w, 3) clip of noise with a square drifting over it for
    a segment: ``(frames, start, end, {frame: [x, y, w, h]})``, ``end``
    inclusive. The noise is drawn as uint8 (a 360p clip of 200 frames is
    138 MB), so the clip is not ``make_synthetic_sample``'s of the seed."""
    rng = np.random.RandomState(seed)
    frames = rng.randint(0, 60, size=(t, h, w, 3), dtype=np.uint8)
    start, end, boxes = _paint_square(rng, frames)
    xywh = {i: [float(x0), float(y0), float(x1 - x0), float(y1 - y0)]
            for i, (x0, y0, x1, y1) in enumerate(boxes) if start <= i <= end}
    return frames, start, end, xywh


def write_vidstg_dir(root: str, n_train: int, n_val: int, t: int = 20, h: int = 60, w: int = 80,
                     seed: int = 0, fps: int = 5, video_max_len_train: int = 200) -> str:
    """``train.json`` and ``val.json`` in the preprocessed VidSTG layout
    (``{videos, trajectories}``, one entry a sentence) and one ``.npy`` clip
    a video (``synthetic_clip``), annotated at ``fps`` frames a second so
    that every frame of a clip is sampled at ``--fps fps``; the train file
    again as ``train_{video_max_len_train}.json``, the name the VidSTG
    loader reads at another ``video_max_len_train`` than 200. Returns
    ``root``: pass it as ``--vidstg_ann_path`` and ``--vidstg_vid_path``."""
    os.makedirs(root, exist_ok=True)
    for split, n, seed0 in (("train", n_train, seed), ("val", n_val, seed + 1000)):
        videos, trajectories = [], {}
        for i in range(n):
            frames, start, end, boxes = synthetic_clip(seed0 + i, t, h, w)
            name = f"{split}{i}"
            np.save(os.path.join(root, f"{name}.npy"), frames)
            videos.append({
                "video_id": i, "original_video_id": name, "target_id": 0, "fps": float(fps),
                "start_frame": 0, "end_frame": t, "tube_start_frame": start,
                "tube_end_frame": end + 1, "caption": "the red square moving on the left",
                "qtype": "declarative", "video_path": f"{name}.npy", "width": w, "height": h,
            })
            trajectories[name] = {"0": {str(f): {"bbox": b} for f, b in boxes.items()}}
        names = [split] + ([f"train_{video_max_len_train}"]
                           if split == "train" and video_max_len_train != 200 else [])
        for name in names:
            with open(os.path.join(root, f"{name}.json"), "w") as f:
                json.dump({"videos": videos, "trajectories": trajectories}, f)
    return root
