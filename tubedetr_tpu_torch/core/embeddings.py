"""Sine position and time embeddings (counterpart of ``tubedetr_tpu/core/embeddings.py``).

Channels-last, computed in float32 and cast to ``dtype`` at the end.
"""

from __future__ import annotations

import math

import torch


def position_embedding_sine(
    pad_mask: torch.Tensor,
    num_pos_feats: int = 128,
    temperature: float = 10000.0,
    scale: float = 2 * math.pi,
    dtype=torch.float32,
) -> torch.Tensor:
    """(..., H, W) bool pad mask -> (..., H, W, 2*num_pos_feats), [y | x]."""
    not_mask = (~pad_mask).to(torch.float32)
    y_embed = torch.cumsum(not_mask, dim=-2)
    x_embed = torch.cumsum(not_mask, dim=-1)
    eps = 1e-6
    y_embed = y_embed / (y_embed[..., -1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[..., :, -1:] + eps) * scale

    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=pad_mask.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / num_pos_feats)

    def interleave(p):
        # sin of even channels interleaved with cos of odd channels
        return torch.stack(
            [torch.sin(p[..., 0::2]), torch.cos(p[..., 1::2])], dim=-1
        ).flatten(-2)

    pos_x = interleave(x_embed[..., None] / dim_t)
    pos_y = interleave(y_embed[..., None] / dim_t)
    return torch.cat([pos_y, pos_x], dim=-1).to(dtype)


def time_embedding_sine(max_len: int, d_model: int, dtype=torch.float32) -> torch.Tensor:
    """(max_len, d_model) transformer sinusoid table: sin on even, cos on odd."""
    position = torch.arange(max_len, dtype=torch.float32)[:, None]
    div_term = torch.exp(
        torch.arange(0, d_model, 2, dtype=torch.float32) * (-math.log(10000.0) / d_model)
    )
    te = torch.zeros(max_len, d_model, dtype=torch.float32)
    te[:, 0::2] = torch.sin(position * div_term)
    te[:, 1::2] = torch.cos(position * div_term[: d_model // 2])
    return te.to(dtype)
