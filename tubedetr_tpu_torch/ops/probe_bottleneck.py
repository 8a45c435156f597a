"""Probes P4 and P5: K2 taken apart, from ``scripts/probe_fused_variants.py``.

* ``bottleneck_variant`` (P4, ``run``): K2's own kernel
  (``csrc/fused_bottleneck.cu``) on the ``(N, H, W, C)`` stream with one
  part switched off. ``full`` is K2; ``noshift`` computes conv1 over the
  band only and reads the centre pixel for all nine taps; ``convonly`` sets
  ``q2 = q1`` and skips conv2.
* ``flat_bottleneck`` (P5, ``run_flat``): K2's function on frames padded to
  a flat row stride, ``(N, HWP, C)`` with ``H*W`` real rows a frame, by K2's
  kernel in its flat layout (``csrc/fused_bottleneck.cu``, ``Layout::kFlat``):
  ``hwpad`` (K2's nine accumulated tap products) or ``im2col`` (conv2 reads
  a patch copied out of the q1 tile a slice of K at a time: the K=9P
  product over a patch). Pad rows come out 0.

``probe_fold`` builds the probe's ``BottleneckFold`` from its raw int8
weights: a=1e-4, b=0 and ``sid = float32(0.01)`` unless told otherwise. A
CUDA tensor launches the kernel and counts it in the wrapper's
``launches``; a CPU tensor runs the plain version. A CUDA tensor never
reaches the plain version.
"""

from __future__ import annotations

import torch

from tubedetr_tpu_torch.ops.fused_bottleneck import (
    BottleneckFold,
    _requant,
    check_input,
    check_kernel,
    check_stream,
    column_strips,
    fused_bottleneck_plain,
    in_strips,
    launch_fold_kernel,
    launch_k2,
    tile_plan,
)
from tubedetr_tpu_torch.ops.int8_conv import int_mm

VARIANTS = ("full", "noshift", "convonly")
FLAT_VARIANTS = ("hwpad", "im2col")
_ENTRY = {
    "full": "fused_bottleneck_s8",
    "noshift": "fused_bottleneck_noshift_s8",
    "convonly": "fused_bottleneck_convonly_s8",
    "hwpad": "fused_bottleneck_flat_hwpad_s8",
    "im2col": "fused_bottleneck_flat_im2col_s8",
}


def probe_fold(w1, w2, w3, a=(1e-4, 1e-4, 1e-4), b=(0.0, 0.0, 0.0), sid=0.01) -> BottleneckFold:
    """The probe's raw int8 weights, ``w1 (C, P)``, ``w2 (9, P, P)``
    ([tap][in][out]) and ``w3 (P, C)``, laid out for K2 (output channel
    first) with per-stage scalar folds ``a``, ``b`` and the residual scale
    ``sid`` (the script's ``acc * 1e-4 + 0 [+ x * 0.01]``)."""
    c, p = w1.shape
    f32 = torch.float32

    def full(n, v):
        return torch.full((n,), v, dtype=f32, device=w1.device)

    return BottleneckFold(
        w1=w1.t().contiguous(),
        w2=w2.transpose(1, 2).contiguous(),
        w3=w3.t().contiguous(),
        a1=full(p, a[0]), b1=full(p, b[0]),
        a2=full(p, a[1]), b2=full(p, b[1]),
        a3=full(c, a[2]), b3=full(c, b[2]),
        sid=full(1, sid),
        so=torch.ones((), dtype=f32, device=w1.device),
    )


def bottleneck_variant_plain(xq: torch.Tensor, fold: BottleneckFold, variant: str) -> torch.Tensor:
    """Plain PyTorch version of a P4 variant on ``(N, H, W, C)``: ``full`` is
    K2's plain version; ``noshift`` sums nine products of ``q1`` with the nine
    taps; ``convonly`` runs conv3 on ``q1``."""
    if variant == "full":
        return fused_bottleneck_plain(xq, fold)
    n, h, w, c = xq.shape
    p = fold.w1.shape[0]
    rows = xq.reshape(n * h * w, c)
    q1 = _requant(int_mm(rows, fold.w1.t()).float() * fold.a1 + fold.b1)
    if variant == "noshift":  # the centre read for every tap: [q1 q1 ... q1] @ [w2_0; ...; w2_8]
        w2 = fold.w2.transpose(0, 1).reshape(p, 9 * p)  # [out][tap, in]
        q2 = _requant(int_mm(q1.repeat(1, 9), w2.t()).float() * fold.a2 + fold.b2)
    elif variant == "convonly":
        q2 = q1
    else:
        raise ValueError(f"unknown variant {variant!r}; expected one of {VARIANTS}")
    y3 = int_mm(q2, fold.w3.t()).float() * fold.a3 + fold.b3 + rows.float() * fold.sid
    return _requant(y3).reshape(n, h, w, c)


def bottleneck_variant(xq: torch.Tensor, fold: BottleneckFold, variant: str) -> torch.Tensor:
    """P4: one variant of K2 on the int8 stream ``(N, H, W, C)`` (dilation 1),
    in K2's column strips."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected one of {VARIANTS}")
    check_input(xq, fold, 1)
    if xq.device.type == "cpu":
        return bottleneck_variant_plain(xq, fold, variant)

    def launch(x):
        out = torch.empty_like(x)
        launch_k2(x, out, fold, 1, _ENTRY[variant])
        bottleneck_variant.launches += 1
        return out

    return in_strips(xq, column_strips(xq.shape[2], fold.channels[1], 1), launch)


bottleneck_variant.launches = 0


def flat_bottleneck_plain(xq: torch.Tensor, fold: BottleneckFold, h: int, w: int) -> torch.Tensor:
    """Plain version of P5: K2's plain version on the ``h*w`` real rows of each
    frame of ``(N, HWP, C)``, the pad rows 0."""
    n, hwp, c = xq.shape
    real = fused_bottleneck_plain(xq[:, : h * w].reshape(n, h, w, c), fold)
    out = torch.zeros_like(xq)
    out[:, : h * w] = real.reshape(n, h * w, c)
    return out


def flat_bottleneck(xq: torch.Tensor, fold: BottleneckFold, variant: str, h: int, w: int) -> torch.Tensor:
    """P5: K2's function on ``(N, HWP, C)`` int8 frames of ``h*w`` real rows
    followed by at least ``w + 1`` pad rows (the script's layout: its taps
    read the pad rows as the vertical border); the pad rows come out 0.
    Dilation 1, one launch."""
    if variant not in FLAT_VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected one of {FLAT_VARIANTS}")
    check_stream(xq, fold, "N, HWP")
    if xq.shape[1] - h * w < w + 1:
        raise ValueError(
            f"a frame of {h}x{w} needs at least {w + 1} pad rows after its {h * w} real "
            f"rows (the vertical border); got {xq.shape[1]} rows a frame"
        )
    if xq.device.type == "cpu":
        return flat_bottleneck_plain(xq, fold, h, w)
    n, hwp, c = xq.shape
    p = fold.w1.shape[0]
    # no column strips: a width whose q1 tile does not fit raises
    check_kernel(xq, fold, n, h, tile_plan(w, p, 1, im2col=variant == "im2col"))
    out = torch.empty_like(xq)  # the kernel writes every row, the pad rows 0
    launch_fold_kernel("fused_bottleneck", _ENTRY[variant], xq, out, fold, (n, hwp, h, w, c, p))
    flat_bottleneck.launches += 1
    return out


flat_bottleneck.launches = 0
