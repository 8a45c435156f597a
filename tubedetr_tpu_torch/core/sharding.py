"""The frame axis over a time group (counterpart of ``tubedetr_tpu/core/sharding.py``).

The JAX package pins the trunk's output to the frame-major layout
(``constrain_frame_major``) and lets GSPMD insert the all-gather. Here the
model does it by hand: each rank of a ``time`` process group runs the trunk
on a contiguous share of the flat ``(B*T)`` frame axis (``frame_share``),
and ``gather_frames`` all-gathers the shares, so that everything after the
trunk runs whole on every rank of the group. Without a time group (one
process, or ``mesh_time = 1``) both are the identity.

The gather's backward returns the rank's own slice of the upstream gradient
times the group's size. Downstream of the gather every rank of the group
computes the same gradient, so a trunk parameter's gradient on a rank covers
only its own frames; the data-parallel mean over all ``data x time`` ranks
then divides by ``mesh_time`` once too often, and the factor restores the
sum over the group's frames.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def frame_share(n: int, size: int, rank: int):
    """(start, stop, share) of rank ``rank``'s contiguous share of ``n``
    frames cut into ``size`` equal shares of ``ceil(n / size)``; the shares
    past ``n`` are padding."""
    share = -(-n // size)
    return rank * share, (rank + 1) * share, share


def local_frames(frames: torch.Tensor, group) -> torch.Tensor:
    """This rank's share of the flat frame batch ``frames`` (N, ...): the
    axis padded to a multiple of the group's size by repeating the last
    frame (a repeat adds no new activation maximum to a calibration), then
    cut into contiguous shares."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    n = frames.shape[0]
    start, stop, share = frame_share(n, size, rank)
    if share * size > n:
        frames = torch.cat([frames, frames[-1:].expand(share * size - n, *frames.shape[1:])])
    return frames[start:stop]


class _GatherFrames(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local: torch.Tensor, n: int, group):
        ctx.group, ctx.n = group, n
        size = dist.get_world_size(group)
        parts = [torch.empty_like(local) for _ in range(size)]
        dist.all_gather(parts, local.contiguous(), group=group)
        return torch.cat(parts)[:n]

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        size, rank = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        start, stop, share = frame_share(ctx.n, size, rank)
        out = grad.new_zeros((share,) + grad.shape[1:])
        real = max(0, min(stop, ctx.n) - start)
        if real:
            out[:real] = grad[start:start + real]
        return out * size, None, None


def gather_frames(local: torch.Tensor, n: int, group: Optional[object]) -> torch.Tensor:
    """The ``n`` frames of the time group's shares of ``local`` (each rank's
    (share, ...) features), concatenated in rank order; ``local`` itself
    without a group."""
    if group is None or dist.get_world_size(group) == 1:
        return local
    return _GatherFrames.apply(local, n, group)
