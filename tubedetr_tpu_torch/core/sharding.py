"""The frame axis over a time group, and the model axis's region functions (counterpart of ``tubedetr_tpu/core/sharding.py``).

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

``to_model``, ``from_model`` and ``gather_hidden`` are Megatron's f and g
and the hidden-dim gather of a tensor-parallel layer (``parallel/tp.py``),
which the JAX package leaves to GSPMD.
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


# ---------------------------------------------------------------------------
# the model axis: Megatron's f and g, and the embedding's hidden-dim gather
# ---------------------------------------------------------------------------
#
# A tensor-parallel layer (``parallel/tp.py``) holds a slice of its weights
# on each rank of a ``model`` process group. Its input enters the sharded
# region through ``to_model`` (f: the identity forward, the sum of the ranks'
# input gradients backward) and its row-parallel output leaves it through
# ``from_model`` (g: the sum of the ranks' partial outputs forward, the
# identity backward). Outside the region every rank of the group computes
# the same values and the same gradients. None of them short-circuits a
# one-rank group: a one-card run still drives the sharded code.


class _ToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _FromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


class _GatherHidden(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local: torch.Tensor, group):
        ctx.group = group
        size = dist.get_world_size(group)
        parts = [torch.empty_like(local) for _ in range(size)]
        dist.all_gather(parts, local.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        size, rank = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return grad.chunk(size, dim=-1)[rank].contiguous(), None


def to_model(x: torch.Tensor, group) -> torch.Tensor:
    """f: ``x`` (the same on every rank of ``group``) entering a column-
    parallel layer; ``x`` itself without a group."""
    return x if group is None else _ToModel.apply(x, group)


def from_model(x: torch.Tensor, group) -> torch.Tensor:
    """g: the sum over ``group`` of each rank's partial ``x`` (a row-parallel
    product, or a share of a mean); ``x`` itself without a group."""
    return x if group is None else _FromModel.apply(x, group)


def gather_hidden(local: torch.Tensor, group) -> torch.Tensor:
    """Each rank's slice of the last (hidden) dim concatenated in rank
    order; backward, the rank's own slice of the gradient."""
    return local if group is None else _GatherHidden.apply(local, group)
