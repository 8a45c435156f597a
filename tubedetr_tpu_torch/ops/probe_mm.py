"""Probes P1-P3: the plain GEMMs of ``scripts/probe_pallas_int8.py``.

Counterparts of that script's Pallas kernels, on ``csrc/probe_mm.cu``: one
persistent, warp-specialised kernel an SM that streams A and B by TMA into a
swizzled shared-memory ring and multiplies with ``wgmma`` (the GEMM method
of ``csrc/wgmma_tiles.cuh``), in two instantiations:

* ``int8_mm`` (P1, ``pl_dot``): ``(rows, K) s8 @ (K, N) s8 -> s32``, the
  row tiles running over the flat rows;
* ``bf16_mm`` (P2, ``pl_dotb``): the same product in bf16 with f32 sums;
* ``int8_mm_frames`` (P3, ``pl_dot3``): the P1 product on ``(frames, HW, K)``,
  the row tiles never crossing a frame, so the last tile of every frame is
  partial (484 rows a frame at the script's shapes).

The weight comes output channel first, ``wt (N, K)``, as K2's folds carry
them: both operands are then K-major, the one layout s8 ``wgmma`` takes. A
CUDA tensor launches the kernel and counts it in the wrapper's
``launches``; a CPU tensor runs the plain version (``torch._int_mm``, or an
f32 product for bf16). A CUDA tensor never reaches the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from tubedetr_tpu_torch.ops import _cuda_build
from tubedetr_tpu_torch.ops.int8_conv import int_mm

N_GROUP = 64  # the kernel takes N in groups of 64 output channels
K_BYTES = 32  # a wgmma k-step reads 32 bytes of each row
ALIGN = 16  # TMA reads from 16-byte aligned bases


def int8_mm_plain(x: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """``x (..., K) s8 @ wt.T`` -> ``(..., N) s32``."""
    out = int_mm(x.reshape(-1, x.shape[-1]), wt.t())
    return out.reshape(*x.shape[:-1], wt.shape[0])


def bf16_mm_plain(x: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """``x (rows, K) bf16 @ wt.T`` -> ``(rows, N) f32``: exact for integer
    inputs whose partial sums stay below 2**24, as the probe's do."""
    return x.float() @ wt.float().t()


def _check(x: torch.Tensor, wt: torch.Tensor, dtype: torch.dtype, dims: int) -> None:
    if x.dtype != dtype or wt.dtype != dtype:
        raise ValueError(f"expected {dtype} operands, got {x.dtype} and {wt.dtype}")
    if x.dim() != dims or wt.dim() != 2 or x.shape[-1] != wt.shape[1]:
        raise ValueError(
            f"expected a {dims}-D x (..., K) and wt (N, K), got {tuple(x.shape)} and {tuple(wt.shape)}"
        )
    if x.device.type not in ("cpu", "cuda") or wt.device != x.device:
        raise ValueError(f"x and wt must lie on one device, the CPU or the card: {x.device}, {wt.device}")
    if x.device.type == "cpu":
        return
    n, k = wt.shape
    if n % N_GROUP or (k * x.element_size()) % K_BYTES:
        raise ValueError(
            f"the kernel takes N a multiple of {N_GROUP} and K a multiple of "
            f"{K_BYTES // x.element_size()}; got N={n}, K={k}"
        )
    if not (x.is_contiguous() and wt.is_contiguous()):
        raise ValueError("x and wt must be contiguous")
    if x.data_ptr() % ALIGN or wt.data_ptr() % ALIGN:
        raise ValueError(f"x and wt must start {ALIGN}-byte aligned (TMA): "
                         f"offsets {x.data_ptr() % ALIGN} and {wt.data_ptr() % ALIGN}")


def smem_bytes() -> int:
    """Dynamic shared memory a block of the kernel requests, from the built
    library (the ring, its barriers and alignment slack)."""
    fn = _cuda_build.load("probe_mm").probe_mm_smem_bytes
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()


def _launch(entry: str, x, wt, out, seg_rows: int) -> None:
    fn = getattr(_cuda_build.load("probe_mm"), entry)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    n, k = wt.shape
    rows = x.numel() // k
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), wt.data_ptr(), out.data_ptr(), rows, n, k, seg_rows, stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")


def int8_mm(x: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """P1: ``x (rows, K) s8 @ wt.T`` with ``wt (N, K) s8`` -> ``(rows, N) s32``."""
    _check(x, wt, torch.int8, 2)
    if x.device.type == "cpu":
        return int8_mm_plain(x, wt)
    out = torch.empty(x.shape[0], wt.shape[0], dtype=torch.int32, device=x.device)
    _launch("probe_mm_s8", x, wt, out, x.shape[0])
    int8_mm.launches += 1
    return out


def int8_mm_frames(x: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """P3: ``x (frames, HW, K) s8 @ wt.T`` -> ``(frames, HW, N) s32``, tiled
    frame by frame."""
    _check(x, wt, torch.int8, 3)
    if x.device.type == "cpu":
        return int8_mm_plain(x, wt)
    out = torch.empty(*x.shape[:2], wt.shape[0], dtype=torch.int32, device=x.device)
    _launch("probe_mm_s8", x, wt, out, x.shape[1])
    int8_mm_frames.launches += 1
    return out


def bf16_mm(x: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """P2: ``x (rows, K) bf16 @ wt.T`` with ``wt (N, K) bf16`` -> ``(rows, N) f32``."""
    _check(x, wt, torch.bfloat16, 2)
    if x.device.type == "cpu":
        return bf16_mm_plain(x, wt)
    out = torch.empty(x.shape[0], wt.shape[0], dtype=torch.float32, device=x.device)
    _launch("probe_mm_bf16", x, wt, out, x.shape[0])
    bf16_mm.launches += 1
    return out


int8_mm.launches = 0
int8_mm_frames.launches = 0
bf16_mm.launches = 0
