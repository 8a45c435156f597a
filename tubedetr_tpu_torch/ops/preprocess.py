"""Bilinear interpolation operators for resize + crop (host side).

The port's copy of ``tubedetr_tpu/ops/preprocess.py:_interp_matrix`` and the
ImageNet statistics. A separable bilinear resize is ``A_h @ img @ A_w^T``;
each row of ``A`` has at most two non-zeros, which ``gather_taps`` hands to
the CUDA kernel as per-output-row tables instead of the dense matrix.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _taps(in_size: int, out_size: int, crop_start: float, crop_size: float):
    """Source taps of each output index, cv2.INTER_LINEAR convention
    (half-pixel centers, clamped borders): (lo, hi, frac)."""
    if crop_size <= 0:
        crop_size = float(in_size)
    scale = crop_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) * scale - 0.5 + crop_start
    src = np.clip(src, 0.0, in_size - 1.0)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    return lo, hi, src - lo


@lru_cache(maxsize=256)
def _interp_matrix(
    in_size: int, out_size: int, crop_start: float = 0.0, crop_size: float = -1.0
) -> np.ndarray:
    """Bilinear interpolation matrix (out_size, in_size). With
    ``crop_start``/``crop_size`` the source window [start, start+size) is
    resized to ``out_size`` (crop fused into the resize)."""
    lo, hi, frac = _taps(in_size, out_size, crop_start, crop_size)
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    rows = np.arange(out_size)
    np.add.at(mat, (rows, lo), (1.0 - frac).astype(np.float32))
    np.add.at(mat, (rows, hi), frac.astype(np.float32))
    return mat


@lru_cache(maxsize=256)
def gather_taps(
    in_size: int, out_size: int, crop_start: float = 0.0, crop_size: float = -1.0
):
    """The two non-zeros of each row of ``_interp_matrix`` as tables
    ``(lo int32, hi int32, w_lo f32, w_hi f32)``, weights read from the
    matrix itself: at a clamped border ``lo == hi`` and ``np.add.at`` merged
    both weights into ``mat[r, lo]``, so ``w_hi`` is 0 there."""
    lo, hi, _ = _taps(in_size, out_size, crop_start, crop_size)
    mat = _interp_matrix(in_size, out_size, crop_start, crop_size)
    rows = np.arange(out_size)
    w_lo = mat[rows, lo]
    w_hi = np.where(hi != lo, mat[rows, hi], np.float32(0.0)).astype(np.float32)
    return lo.astype(np.int32), hi.astype(np.int32), w_lo, w_hi


def norm_affine():
    """Per-channel (scale, shift) folding /255 and the ImageNet mean/std:
    ``(x/255 - mean)/std == x*scale + shift``, as K1 applies it."""
    std = np.asarray(IMAGENET_STD, np.float32)
    scale = (1.0 / (255.0 * std)).astype(np.float32)
    shift = (-np.asarray(IMAGENET_MEAN, np.float32) / std).astype(np.float32)
    return scale, shift
