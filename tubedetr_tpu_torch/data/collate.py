"""Collation into static-shaped, padded batches (counterpart of ``tubedetr_tpu/data/collate.py``).

Every video pads to exactly ``T`` frames and ``Tc = ceil(T / stride)`` clips,
space pads to the batch's largest (bucketed) frame, and ragged structure is
carried by boolean masks (True on padding). Masks, tokens and durations are
built on the host; the frames stay tensors on the device they arrive on, so
the serving path never copies pixels back to the host. The training targets
(``target_boxes``, ``inter_idx``, ``time_mask``) stay numpy arrays; the train
step moves them to the device.

``split_video_into_clips`` is the evaluation's ``div_vid`` split of a long
video into clips that share its id, so ``postprocess_sted`` ensembles them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch


@dataclass
class VideoSample:
    """One decoded and spatially transformed video."""

    frames: torch.Tensor  # (t, H, W, 3) normalized, padded to the size bucket
    valid_hw: tuple  # (h, w) valid pixel extent inside (H, W)
    frames_id: List[int]  # real frame ids, len == t
    video_id: object
    caption: str
    tokens: Optional[np.ndarray] = None  # (L,) int
    orig_size: tuple = (0, 0)  # (h, w) before transforms
    # what evaluation reads; serving leaves the defaults
    boxes_cxcywh: Optional[np.ndarray] = None  # (t, 4) normalized, zeros outside the moment
    inter_idx: tuple = (-100, -100)  # (start, end) inclusive; (-100, -100) if empty
    qtype: str = "declarative"


def collate(
    samples: List[VideoSample],
    t: int,
    stride: int,
    max_text_len: int,
    with_fast: bool = True,
    compact_pad_masks: bool = False,
) -> Dict:
    """The model's input dict for ``samples``, plus the targets:
    ``time_mask`` (B, T), True on valid frames, ``target_boxes`` (B, T, 4)
    cxcywh (zeros where a sample has none) and ``inter_idx`` (B, 2). The
    slow stream is ``frames[::stride]`` and the fast stream all frames.
    Frames and masks land on the frames' device. ``compact_pad_masks``
    gives each frame's valid extent, ``{fast,slow}_valid_hw`` (B, T, 2),
    in place of the dense pixel pad masks (``parallel/train_step.py:
    expand_pad_masks`` rebuilds them)."""
    b = len(samples)
    tc = math.ceil(t / stride) if stride else t
    hmax = max(s.frames.shape[1] for s in samples)
    wmax = max(s.frames.shape[2] for s in samples)
    dev = samples[0].frames.device
    dtype = samples[0].frames.dtype

    frames_fast = torch.zeros((b, t, hmax, wmax, 3), dtype=dtype, device=dev)
    frames_slow = torch.zeros((b, tc, hmax, wmax, 3), dtype=dtype, device=dev)
    fast_pad = np.ones((b, t, hmax, wmax), bool)
    slow_pad = np.ones((b, tc, hmax, wmax), bool)
    fast_valid_hw = np.zeros((b, t, 2), np.int64)
    slow_valid_hw = np.zeros((b, tc, 2), np.int64)
    target_boxes = np.zeros((b, t, 4), np.float32)
    inter_idx = np.full((b, 2), -100, np.int64)
    durations = np.zeros((b,), np.int64)
    time_mask = np.zeros((b, t), bool)
    tokens = np.zeros((b, max_text_len), np.int64)
    text_pad = np.ones((b, max_text_len), bool)

    for i, s in enumerate(samples):
        st = min(s.frames.shape[0], t)
        fh, fw = s.frames.shape[1:3]
        vh, vw = s.valid_hw
        frames_fast[i, :st, :fh, :fw] = s.frames[:st]
        fast_pad[i, :st, :vh, :vw] = False
        fast_valid_hw[i, :st] = (vh, vw)
        slow = s.frames[:st][::stride] if stride else s.frames[:st]
        sc = slow.shape[0]
        frames_slow[i, :sc, :fh, :fw] = slow
        slow_pad[i, :sc, :vh, :vw] = False
        slow_valid_hw[i, :sc] = (vh, vw)
        if s.boxes_cxcywh is not None:
            target_boxes[i, :st] = s.boxes_cxcywh[:st]
        inter_idx[i] = s.inter_idx
        durations[i] = st
        time_mask[i, :st] = True
        if s.tokens is not None:
            lt = min(len(s.tokens), max_text_len)
            tokens[i, :lt] = s.tokens[:lt]
            text_pad[i, :lt] = False

    def on_dev(a):
        return torch.from_numpy(a).to(dev)

    batch = {
        "frames_slow": frames_slow,
        "tokens": on_dev(tokens),
        "text_pad_mask": on_dev(text_pad),
        "durations": on_dev(durations),
        "time_mask": time_mask,
        "target_boxes": target_boxes,
        "inter_idx": inter_idx,
    }
    streams = {"slow": (slow_pad, slow_valid_hw)}
    if with_fast:
        batch["frames_fast"] = frames_fast
        streams["fast"] = (fast_pad, fast_valid_hw)
    for stream, (pad, valid_hw) in streams.items():
        if compact_pad_masks:
            batch[f"{stream}_valid_hw"] = on_dev(valid_hw)
        else:
            batch[f"{stream}_pad_mask"] = on_dev(pad)
    return batch


MODEL_INPUTS = (
    "frames_slow", "slow_pad_mask", "tokens", "text_pad_mask", "durations",
    "frames_fast", "fast_pad_mask",
)


def model_inputs(batch: Dict) -> Dict:
    """The keyword arguments of ``TubeDETR.forward`` from a collated batch."""
    return {k: batch[k] for k in MODEL_INPUTS if k in batch}


def split_video_into_clips(sample: VideoSample, clip_len: int) -> List[VideoSample]:
    """Chop a long video into ``ceil(t / clip_len)`` clips that share its
    id and caption; each clip's ``inter_idx`` is re-offset into the clip, or
    ``(-100, -100)`` where the clip misses the moment."""
    t = sample.frames.shape[0]
    out = []
    for c in range(math.ceil(t / clip_len)):
        lo, hi = c * clip_len, min((c + 1) * clip_len, t)
        s0, e0 = sample.inter_idx
        if s0 < 0 or e0 < lo or s0 >= hi:
            inter = (-100, -100)
        else:
            inter = (max(s0, lo) - lo, min(e0, hi - 1) - lo)
        boxes = sample.boxes_cxcywh
        out.append(VideoSample(
            frames=sample.frames[lo:hi],
            valid_hw=sample.valid_hw,
            frames_id=sample.frames_id[lo:hi],
            video_id=sample.video_id,
            caption=sample.caption,
            tokens=sample.tokens,
            orig_size=sample.orig_size,
            boxes_cxcywh=None if boxes is None else boxes[lo:hi],
            inter_idx=inter,
            qtype=sample.qtype,
        ))
    return out


def batch_meta(samples: List[VideoSample]) -> Dict:
    """The host-side record of a batch that evaluation reads."""
    return {
        "frames_id": [list(s.frames_id) for s in samples],
        "video_ids": [s.video_id for s in samples],
        "captions": [s.caption for s in samples],
        "qtypes": [s.qtype for s in samples],
        "orig_sizes": [s.orig_size for s in samples],
    }


def collate_pairs(samples: List[VideoSample], batch_size: int, t: int, stride: int,
                  max_text_len: int, div_vid: int = 0, with_fast: bool = True,
                  compact_pad_masks: bool = False) -> List[tuple]:
    """``(batch, meta)`` for each group of ``batch_size`` samples, in order.
    With ``div_vid`` each sample is first cut into clips of ``div_vid``
    frames (the evaluation's split; all clips of a group go into one batch)
    and the batch is ``div_vid`` frames long."""
    pairs = []
    for i in range(0, len(samples), batch_size):
        group = samples[i:i + batch_size]
        if div_vid:
            group = [c for s in group for c in split_video_into_clips(s, div_vid)]
        batch = collate(group, div_vid or t, stride, max_text_len, with_fast=with_fast,
                        compact_pad_masks=compact_pad_masks)
        pairs.append((batch, batch_meta(group)))
    return pairs
