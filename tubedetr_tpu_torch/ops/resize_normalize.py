"""K1: fused resize (+ crop) + normalize of uint8 NHWC frames.

``resize_normalize`` launches the CUDA kernel of ``csrc/resize_normalize.cu``
for a tensor on the card and counts each launch in
``resize_normalize.launches``. For a tensor on the CPU it runs the plain
version, ``resize_normalize_plain``: the two dense f32 contractions of the
JAX package's ``ops/preprocess.py`` and the affine of its Pallas kernel
(``ops/pallas_preprocess.py``). A CUDA tensor never reaches the plain version.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional, Tuple

import torch

from tubedetr_tpu_torch.ops import _cuda_build
from tubedetr_tpu_torch.ops.preprocess import _interp_matrix, gather_taps, norm_affine

_OUT_DTYPES = (torch.float32, torch.bfloat16)
_GRID_LIMIT = 65535  # gridDim.y / gridDim.z carry output rows / frames


def _axis_args(ih: int, iw: int, crop: Optional[Tuple]):
    """Per-axis (in_size, crop_start, crop_size) for the interpolation."""
    if crop is None:
        return (ih, 0.0, -1.0), (iw, 0.0, -1.0)
    top, left, ch, cw = crop
    return (ih, float(top), float(ch)), (iw, float(left), float(cw))


@lru_cache(maxsize=64)
def _device_matrix(in_size: int, out_size: int, start: float, size: float, device: str):
    return torch.from_numpy(_interp_matrix(in_size, out_size, start, size)).to(device)


@lru_cache(maxsize=8)
def _device_affine(device: str):
    return tuple(torch.from_numpy(v).to(device) for v in norm_affine())


def resize_normalize_plain(
    frames: torch.Tensor, out_h: int, out_w: int,
    crop: Optional[Tuple] = None, out_dtype=torch.float32,
) -> torch.Tensor:
    """Plain PyTorch version of K1: ``A_h @ img @ A_w^T`` as two dense f32
    einsums, then ``x*scale + shift``, then the output dtype."""
    (ih, ty, sy), (iw, tx, sx) = _axis_args(frames.shape[1], frames.shape[2], crop)
    dev = str(frames.device)
    ah = _device_matrix(ih, out_h, ty, sy, dev)
    aw = _device_matrix(iw, out_w, tx, sx, dev)
    scale, shift = _device_affine(dev)
    x = frames.to(torch.float32)
    x = torch.einsum("oh,nhwc->nowc", ah, x)
    x = torch.einsum("pw,nowc->nopc", aw, x)
    return (x * scale + shift).to(out_dtype)


@lru_cache(maxsize=64)
def _device_taps(in_size: int, out_size: int, start: float, size: float, device: str):
    lo, hi, w_lo, w_hi = gather_taps(in_size, out_size, start, size)
    return tuple(torch.from_numpy(a).to(device) for a in (lo, hi, w_lo, w_hi))


def _launch(frames, out, rows, cols, out_dtype) -> None:
    lib = _cuda_build.load("resize_normalize")
    fn = lib.resize_normalize_u8
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 8
            + [ctypes.c_float] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    scale, shift = norm_affine()
    n, ih, iw, _ = frames.shape
    _, oh, ow, _ = out.shape
    stream = torch.cuda.current_stream(frames.device).cuda_stream
    err = fn(
        frames.data_ptr(), out.data_ptr(), int(out_dtype == torch.bfloat16),
        *(t.data_ptr() for t in rows), *(t.data_ptr() for t in cols),
        *(float(v) for v in scale), *(float(v) for v in shift),
        n, ih, iw, oh, ow, stream,
    )
    if err != 0:
        raise RuntimeError(f"resize_normalize kernel launch failed: CUDA error {err}")


def resize_normalize(
    frames: torch.Tensor,  # (N, ih, iw, 3) uint8, contiguous
    out_h: int,
    out_w: int,
    crop: Optional[Tuple] = None,  # (top, left, height, width) source window
    out_dtype=torch.float32,
) -> torch.Tensor:
    """Fused [crop ->] bilinear resize -> /255 -> ImageNet normalize.

    Returns (N, out_h, out_w, 3) in ``out_dtype`` (float32 or bfloat16) on
    the input's device."""
    if frames.dtype != torch.uint8 or frames.dim() != 4 or frames.shape[-1] != 3:
        raise ValueError(
            f"expected (N, H, W, 3) uint8 frames, got {tuple(frames.shape)} {frames.dtype}"
        )
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if out_h <= 0 or out_w <= 0:
        raise ValueError(f"bad output size {(out_h, out_w)}")
    if frames.device.type == "cpu":
        return resize_normalize_plain(frames, out_h, out_w, crop, out_dtype)
    if frames.device.type != "cuda":
        raise ValueError(f"unsupported device {frames.device}")
    if not frames.is_contiguous():
        raise ValueError("frames must be contiguous (N, H, W, 3)")
    n = frames.shape[0]
    if n > _GRID_LIMIT or out_h > _GRID_LIMIT:
        raise ValueError(f"at most {_GRID_LIMIT} frames and output rows per launch")
    (ih, ty, sy), (iw, tx, sx) = _axis_args(frames.shape[1], frames.shape[2], crop)
    dev = str(frames.device)
    rows = _device_taps(ih, out_h, ty, sy, dev)
    cols = _device_taps(iw, out_w, tx, sx, dev)
    out = torch.empty((n, out_h, out_w, 3), dtype=out_dtype, device=frames.device)
    with torch.cuda.device(frames.device):
        _launch(frames, out, rows, cols, out_dtype)
    resize_normalize.launches += 1
    return out


resize_normalize.launches = 0
