"""Padding-mask helpers (counterpart of ``tubedetr_tpu/core/masking.py``).

Convention: boolean pad masks are True on PADDED positions.
"""

from __future__ import annotations

import torch


def frame_to_clip(t: int, stride: int, device=None) -> torch.Tensor:
    """(T,) map frame index -> owning clip index (i // k)."""
    idx = torch.arange(t, device=device)
    return idx // stride if stride else idx


def downsample_pad_mask(mask: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Nearest downsample of a (..., H, W) bool mask: src = floor(dst * in/out),
    with the ratio applied in float32 as the JAX package does."""
    h, w = mask.shape[-2], mask.shape[-1]
    dev = mask.device
    ys = (torch.arange(out_h, device=dev, dtype=torch.float32) * (h / out_h)).long()
    xs = (torch.arange(out_w, device=dev, dtype=torch.float32) * (w / out_w)).long()
    return mask[..., ys, :][..., :, xs]


def time_pad_mask(durations: torch.Tensor, t: int) -> torch.Tensor:
    """(B,) int durations -> (B, T) bool, True on frames past the duration."""
    return torch.arange(t, device=durations.device)[None] >= durations[:, None]


def clip_pad_mask(durations: torch.Tensor, n_clips: int, stride: int) -> torch.Tensor:
    """(B,) durations -> (B, n_clips) bool, True on clips past ceil(dur / k)."""
    n_valid = -(-durations // stride)
    return torch.arange(n_clips, device=durations.device)[None] >= n_valid[:, None]


def inter_positive_map(inter_idx: torch.Tensor, t: int) -> torch.Tensor:
    """(B, 2) inclusive [start, end] moment indices -> (B, T) bool in-moment
    map; a row with start < 0 (an empty intersection, [-100, -100]) is all
    False."""
    ar = torch.arange(t, device=inter_idx.device)[None]
    start, end = inter_idx[:, 0:1], inter_idx[:, 1:2]
    return (ar >= start) & (ar <= end) & (start >= 0)


def force_first_valid(pad_mask: torch.Tensor) -> torch.Tensor:
    """A copy of ``pad_mask`` with position 0 of the last axis valid, so no
    row is all padding (the reference's "avoid empty masks")."""
    out = pad_mask.clone()
    out[..., 0] = False
    return out
