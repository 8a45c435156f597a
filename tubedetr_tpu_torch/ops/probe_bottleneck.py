"""Probes P4 and P5: K2 taken apart, from ``scripts/probe_fused_variants.py``.

* ``bottleneck_variant`` (P4, ``run``): K2's own kernel
  (``csrc/fused_bottleneck.cu``) on the ``(N, H, W, C)`` stream with one
  part switched off. ``full`` is K2; ``noshift`` computes conv1 over the
  band only and reads the centre pixel for all nine taps; ``convonly`` sets
  ``q2 = q1`` and skips conv2.
* ``flat_bottleneck`` (P5, ``run_flat``): K2's function on frames padded to
  a flat row stride, ``(N, HWP, C)`` with ``H*W`` real rows a frame, by
  ``csrc/probe_flat_bottleneck.cu``: ``hwpad`` (nine accumulated shifted
  products) or ``im2col`` (one K=9P product over a patch in shared memory).
  Pad rows come out 0.

``probe_fold`` builds the probe's ``BottleneckFold`` from its raw int8
weights: a=1e-4, b=0 and ``sid = float32(0.01)`` unless told otherwise. A
CUDA tensor launches the kernel and counts it in the wrapper's
``launches``; a CPU tensor runs the plain version. A CUDA tensor never
reaches the plain version.
"""

from __future__ import annotations

import torch

from tubedetr_tpu_torch.ops.fused_bottleneck import (
    SMEM_LIMIT,
    SMEM_PAD,
    BottleneckFold,
    _requant,
    check_input,
    check_stream,
    fused_bottleneck_plain,
    launch_fold_kernel,
    launch_k2,
)
from tubedetr_tpu_torch.ops.int8_conv import int_mm

VARIANTS = ("full", "noshift", "convonly")
FLAT_VARIANTS = ("hwpad", "im2col")
_ENTRY = {
    "full": "fused_bottleneck_s8",
    "noshift": "fused_bottleneck_noshift_s8",
    "convonly": "fused_bottleneck_convonly_s8",
}
# rows_per_block<V>() of csrc/probe_flat_bottleneck.cu; a card test holds
# flat_smem_bytes to the library's own count
FLAT_ROWS_PER_BLOCK = {"hwpad": 128, "im2col": 64}


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
    """P4: one variant of K2 on the int8 stream ``(N, H, W, C)`` (dilation 1)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected one of {VARIANTS}")
    check_input(xq, fold, 1)
    if xq.device.type == "cpu":
        return bottleneck_variant_plain(xq, fold, variant)
    out = torch.empty_like(xq)
    launch_k2(xq, out, fold, 1, _ENTRY[variant])
    bottleneck_variant.launches += 1
    return out


bottleneck_variant.launches = 0


def flat_smem_bytes(variant: str, w: int, p: int) -> int:
    """Shared memory of one P5 block: the q1 tile (the block's rows and a
    halo of ``w + 1`` rows each side) with a zero row, q2, and for
    ``im2col`` the ``(rows, 9P)`` patch; each row padded by 16 bytes."""
    rb = FLAT_ROWS_PER_BLOCK[variant]
    ps = p + SMEM_PAD
    extra = rb * (9 * p + SMEM_PAD) if variant == "im2col" else 0
    return (rb + 2 * (w + 1) + 1 + rb) * ps + extra


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
    followed by at least ``w + 1`` pad rows; the pad rows come out 0."""
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
    if flat_smem_bytes(variant, w, p) > SMEM_LIMIT:
        raise ValueError(
            f"P5 {variant} at width {w} with {p} channels needs "
            f"{flat_smem_bytes(variant, w, p)} bytes of shared memory, more than {SMEM_LIMIT}"
        )
    out = torch.empty_like(xq)
    launch_fold_kernel("probe_flat_bottleneck", f"flat_bottleneck_{variant}_s8", xq, out, fold,
                       (n, hwp, h, w, c, p))
    flat_bottleneck.launches += 1
    return out


flat_bottleneck.launches = 0
