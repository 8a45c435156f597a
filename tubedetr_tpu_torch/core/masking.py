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
