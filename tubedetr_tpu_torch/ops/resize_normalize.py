"""K1: fused resize (+ crop) + normalize of uint8 NHWC frames.

``resize_normalize`` launches the CUDA kernel of ``csrc/resize_normalize.cu``
for a tensor on the card and counts each launch in
``resize_normalize.launches``. For a tensor on the CPU it runs the plain
version, ``resize_normalize_plain``: the two dense f32 contractions of the
JAX package's ``ops/preprocess.py`` and the affine of its Pallas kernel
(``ops/pallas_preprocess.py``). A CUDA tensor never reaches the plain version.
With ``pad_to=(ph, pw)`` both return ``(N, ph, pw, 3)``, zero outside the
resized frame: the serving pipeline's bucket pad, written by the kernel in
the same launch.

The kernel's schedule (``k1_schedule``): a block takes a band of output rows
of one frame; it stages the source bytes ``[x_lo, x_lo + x_len)`` of every
source row the band reads into shared memory at once, then per output row
computes the row a pixel a thread into a row buffer and writes it as
8-element chunks of the flat output at 8-aligned element indices. The band height is the tallest (at
most ``MAX_ROWS_PER_BLOCK``) whose shared memory stays within
``SMEM_TARGET``. ``tests/test_torch_preprocess.py`` rebuilds the kernel from
the schedule in plain PyTorch.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from tubedetr_tpu_torch.ops import _cuda_build
from tubedetr_tpu_torch.ops.preprocess import _interp_matrix, gather_taps, norm_affine

_OUT_DTYPES = (torch.float32, torch.bfloat16)
_GRID_LIMIT = 65535  # gridDim.y carries the frames (gridDim.x the bands of rows)
MAX_ROWS_PER_BLOCK = 16
SMEM_TARGET = 40 * 1024  # a block's shared memory, so that five blocks share an SM
CHUNK = 8  # output elements a thread stores at once
SMEM_LIMIT = 232448  # opt-in shared memory of one block on sm_90


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
    pad_to: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Plain PyTorch version of K1: ``A_h @ img @ A_w^T`` as two dense f32
    einsums, then ``x*scale + shift``, then the output dtype, then the zero
    pad to ``pad_to``."""
    (ih, ty, sy), (iw, tx, sx) = _axis_args(frames.shape[1], frames.shape[2], crop)
    dev = str(frames.device)
    ah = _device_matrix(ih, out_h, ty, sy, dev)
    aw = _device_matrix(iw, out_w, tx, sx, dev)
    scale, shift = _device_affine(dev)
    x = frames.to(torch.float32)
    x = torch.einsum("oh,nhwc->nowc", ah, x)
    x = torch.einsum("pw,nowc->nopc", aw, x)
    x = (x * scale + shift).to(out_dtype)
    if pad_to is None:
        return x
    out = x.new_zeros((x.shape[0], *pad_to, 3))
    out[:, :out_h, :out_w] = x
    return out


def smem_bytes(out_w: int, pad_w: int, x_len: int, slots: int, rows_per_block: int) -> int:
    """Dynamic shared memory of one block (``smem_of`` in the kernel): the
    column tables, the band's row entries, two output row buffers of
    ``3*pad_w`` elements and an 8-element chunk (4 bytes an element),
    ``slots`` staged source rows (each at its address mod 16)."""
    return (16 * out_w + 16 * rows_per_block + 8 * ((3 * pad_w + 7) // 8 + 1) * 8
            + slots * ((x_len + 30) // 16 * 16))


@dataclass(frozen=True)
class K1Schedule:
    """What the kernel reads besides the frames: its band height, the source
    rows of each band and the tap tables, as int32 numpy arrays."""

    rows_per_block: int
    slots: int  # source rows a band stages, at most
    band_src: np.ndarray  # (bands, slots): each band's source rows in order, -1 unused
    rows: np.ndarray  # (out_h, 4): slots of the two source rows in the band, w_lo bits, w_hi bits
    cols: np.ndarray  # (out_w, 4): 3*lo - x_lo, 3*hi - x_lo, w_lo bits, w_hi bits
    x_lo: int  # the staged bytes of a source row: [x_lo, x_lo + x_len), from the
    x_len: int  # first column tap to the last, every channel

    pad_w: int  # output columns a row holds, the pad included

    @property
    def smem_bytes(self) -> int:
        return smem_bytes(self.cols.shape[0], self.pad_w, self.x_len, self.slots,
                          self.rows_per_block)


@lru_cache(maxsize=64)
def k1_schedule(ih: int, iw: int, out_h: int, out_w: int, crop: Optional[Tuple] = None,
                pad_to: Optional[Tuple[int, int]] = None) -> K1Schedule:
    """K1's schedule for ``(ih, iw) -> (out_h, out_w)`` written into
    ``pad_to`` (default: the output size): the tallest band (at most
    ``MAX_ROWS_PER_BLOCK`` rows) whose staged source rows keep a block
    within ``SMEM_TARGET`` bytes of shared memory (one row a band if none
    does)."""
    (_, ty, sy), (_, tx, sx) = _axis_args(ih, iw, crop)
    rl, rh, rwl, rwh = gather_taps(ih, out_h, ty, sy)
    cl, ch, cwl, cwh = gather_taps(iw, out_w, tx, sx)
    x_lo = 3 * int(cl.min())
    x_len = 3 * int(ch.max()) + 3 - x_lo
    pad_h, pad_w = pad_to or (out_h, out_w)
    for rpb in range(MAX_ROWS_PER_BLOCK, 0, -1):
        needed = [np.unique(np.concatenate([rl[y:y + rpb], rh[y:y + rpb]]))
                  for y in range(0, pad_h, rpb)]  # empty past out_h
        slots = max(len(n) for n in needed)
        if rpb == 1 or smem_bytes(out_w, pad_w, x_len, slots, rpb) <= SMEM_TARGET:
            break
    band_src = np.full((len(needed), slots), -1, np.int32)
    slot_lo, slot_hi = np.empty(out_h, np.int64), np.empty(out_h, np.int64)
    for b, n in enumerate(needed):
        band_src[b, :len(n)] = n
        y = slice(b * rpb, min((b + 1) * rpb, out_h))
        slot_lo[y], slot_hi[y] = np.searchsorted(n, rl[y]), np.searchsorted(n, rh[y])
    rows = np.stack([slot_lo, slot_hi, rwl.view(np.int32), rwh.view(np.int32)], axis=1)
    cols = np.stack([3 * cl - x_lo, 3 * ch - x_lo, cwl.view(np.int32), cwh.view(np.int32)], axis=1)
    return K1Schedule(rpb, slots, band_src, rows.astype(np.int32), cols.astype(np.int32),
                      x_lo, x_len, pad_w)


@lru_cache(maxsize=64)
def _device_schedule(ih: int, iw: int, out_h: int, out_w: int, crop, pad_to, device: str):
    sched = k1_schedule(ih, iw, out_h, out_w, crop, pad_to)
    tables = tuple(torch.from_numpy(a).to(device) for a in (sched.rows, sched.cols, sched.band_src))
    return sched, tables


def _launch(frames, out, out_h, out_w, sched: K1Schedule, tables) -> None:
    lib = _cuda_build.load("resize_normalize")
    fn = lib.resize_normalize_u8
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 3
            + [ctypes.c_float] * 6 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    scale, shift = norm_affine()
    n, ih, iw, _ = frames.shape
    _, ph, pw, _ = out.shape
    stream = torch.cuda.current_stream(frames.device).cuda_stream
    err = fn(
        frames.data_ptr(), out.data_ptr(), int(out.dtype == torch.bfloat16),
        *(t.data_ptr() for t in tables),
        *(float(v) for v in scale), *(float(v) for v in shift),
        n, ih, iw, out_h, out_w, ph, pw, sched.x_lo, sched.x_len, sched.rows_per_block,
        sched.slots, stream,
    )
    if err != 0:
        raise RuntimeError(f"resize_normalize kernel launch failed: CUDA error {err}")


def resize_normalize(
    frames: torch.Tensor,  # (N, ih, iw, 3) uint8, contiguous
    out_h: int,
    out_w: int,
    crop: Optional[Tuple] = None,  # (top, left, height, width) source window
    out_dtype=torch.float32,
    pad_to: Optional[Tuple[int, int]] = None,  # (ph, pw) >= (out_h, out_w)
) -> torch.Tensor:
    """Fused [crop ->] bilinear resize -> /255 -> ImageNet normalize [-> zero
    pad].

    Returns (N, out_h, out_w, 3), or (N, ph, pw, 3) with ``pad_to``, in
    ``out_dtype`` (float32 or bfloat16) on the input's device."""
    if frames.dtype != torch.uint8 or frames.dim() != 4 or frames.shape[-1] != 3:
        raise ValueError(
            f"expected (N, H, W, 3) uint8 frames, got {tuple(frames.shape)} {frames.dtype}"
        )
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if out_h <= 0 or out_w <= 0:
        raise ValueError(f"bad output size {(out_h, out_w)}")
    if pad_to is not None:
        pad_to = (int(pad_to[0]), int(pad_to[1]))
        if pad_to[0] < out_h or pad_to[1] < out_w:
            raise ValueError(f"pad_to {pad_to} is smaller than the output size {(out_h, out_w)}")
    if frames.device.type == "cpu":
        return resize_normalize_plain(frames, out_h, out_w, crop, out_dtype, pad_to)
    if frames.device.type != "cuda":
        raise ValueError(f"unsupported device {frames.device}")
    if not frames.is_contiguous():
        raise ValueError("frames must be contiguous (N, H, W, 3)")
    n, ih, iw, _ = frames.shape
    if n > _GRID_LIMIT:
        raise ValueError(f"at most {_GRID_LIMIT} frames per launch")
    crop = None if crop is None else tuple(crop)
    ph, pw = pad_to or (out_h, out_w)
    sched, tables = _device_schedule(ih, iw, out_h, out_w, crop, (ph, pw), str(frames.device))
    if sched.smem_bytes > SMEM_LIMIT:
        raise ValueError(
            f"source rows of {sched.x_len} bytes and {out_w} output columns need "
            f"{sched.smem_bytes} bytes of shared memory, more than {SMEM_LIMIT}"
        )
    # torch.empty: every element, the pad included, is the kernel's to write
    out = torch.empty((n, ph, pw, 3), dtype=out_dtype, device=frames.device)
    with torch.cuda.device(frames.device):
        _launch(frames, out, out_h, out_w, sched, tables)
    resize_normalize.launches += 1
    return out


resize_normalize.launches = 0
