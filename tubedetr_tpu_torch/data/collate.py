"""Collation into static-shaped, padded batches (counterpart of ``tubedetr_tpu/data/collate.py``).

Every video pads to exactly ``T`` frames and ``Tc = ceil(T / stride)`` clips,
space pads to the batch's largest (bucketed) frame, and ragged structure is
carried by boolean masks (True on padding). Masks, tokens and durations are
built on the host; the frames stay tensors on the device they arrive on, so
the serving path never copies pixels back to the host.
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


def collate(
    samples: List[VideoSample],
    t: int,
    stride: int,
    max_text_len: int,
    with_fast: bool = True,
) -> Dict:
    """The model's input dict for ``samples``, plus ``time_mask`` (B, T),
    True on valid frames. The slow stream is ``frames[::stride]`` and the
    fast stream all frames. Frames and masks land on the frames' device."""
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
        slow = s.frames[:st][::stride] if stride else s.frames[:st]
        sc = slow.shape[0]
        frames_slow[i, :sc, :fh, :fw] = slow
        slow_pad[i, :sc, :vh, :vw] = False
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
        "slow_pad_mask": on_dev(slow_pad),
        "tokens": on_dev(tokens),
        "text_pad_mask": on_dev(text_pad),
        "durations": on_dev(durations),
        "time_mask": time_mask,
    }
    if with_fast:
        batch["frames_fast"] = frames_fast
        batch["fast_pad_mask"] = on_dev(fast_pad)
    return batch


MODEL_INPUTS = (
    "frames_slow", "slow_pad_mask", "tokens", "text_pad_mask", "durations",
    "frames_fast", "fast_pad_mask",
)


def model_inputs(batch: Dict) -> Dict:
    """The keyword arguments of ``TubeDETR.forward`` from a collated batch."""
    return {k: batch[k] for k in MODEL_INPUTS if k in batch}
