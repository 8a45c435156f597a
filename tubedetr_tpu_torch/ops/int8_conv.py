"""s8 x s8 -> s32 convolutions for the unfused int8 trunks.

Counterpart of the XLA ``conv_general_dilated(int8, int8,
preferred_element_type=int32)`` in ``tubedetr_tpu/models/resnet.py``
(``BottleneckConv``). The JAX package leaves these convs to XLA, outside any
Pallas kernel, so here they are a library product: ``torch._int_mm``
(cuBLASLt on the card, a plain integer GEMM on the CPU) over NHWC rows.

* A 1x1 conv (stride 1 or 2) is one product over the ``(N*H*W, C)`` rows of
  the (subsampled) input.
* A kxk conv (stride, dilation, zero padding ``dilation * (k // 2)``) is an
  int8 im2col, taps in (ky, kx) order, then one product with the HWIO
  kernel flattened to ``(k*k*C, O)``.

Weights arrive as ``(O, K)`` contiguous int8 and enter the product as the
transposed view ``(K, O)``: the column-major second operand cuBLASLt's int8
GEMM takes without a copy.

A grouped conv (the timm trunks' depthwise and grouped 3x3 convs, XLA's
``feature_group_count``) does not fit that product: a depthwise group has
one output channel, and ``torch._int_mm`` on the card wants K and N in
multiples of 8. PyTorch has no int8 grouped convolution (cuDNN's float32
one on the same integers is exact at these shapes: it is G1's yardstick),
so ``grouped_conv2d_int8`` launches G1, the hand-written kernel of
``csrc/grouped_conv_s8.cu``, on a CUDA tensor (it raises on what the kernel
does not take) and runs its plain version, ``grouped_conv2d_int8_plain``, on
a CPU tensor. G1 computes the conv and the int8 fold of
``models/resnet.py:_qforward`` in one launch, ``dtype(float32(acc) *
scale)``, so no int32 tensor reaches device memory. Its ``launches``
counter counts the kernel's launches; ``g1_path`` says which of the
kernel's paths a shape takes.
"""

from __future__ import annotations

import ctypes

import torch
from torch.nn import functional as F

from tubedetr_tpu_torch.ops import _cuda_build

_CUDA_MIN_ROWS = 17  # torch._int_mm on CUDA needs more than 16 rows


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(M, K) s8 @ (K, N) s8 -> (M, N) s32``. On the card K and N must be
    multiples of 8; fewer than 17 rows are zero-padded and cut back."""
    m = a.shape[0]
    if a.is_cuda and m < _CUDA_MIN_ROWS:
        a = torch.cat([a, a.new_zeros((_CUDA_MIN_ROWS - m, a.shape[1]))])
        return torch._int_mm(a, b)[:m]
    return torch._int_mm(a, b)


def im2col(xq: torch.Tensor, k: int, stride: int = 1, dilation: int = 1) -> torch.Tensor:
    """``(N, H, W, C)`` int8 -> ``(N, Ho, Wo, k*k*C)``: the k*k dilated taps
    of each output pixel, in (ky, kx, c) order, over a zero border of
    ``dilation * (k // 2)``."""
    n, h, w, c = xq.shape
    pad = dilation * (k // 2)
    xp = F.pad(xq, (0, 0, pad, pad, pad, pad))
    ho = (h + 2 * pad - dilation * (k - 1) - 1) // stride + 1
    wo = (w + 2 * pad - dilation * (k - 1) - 1) // stride + 1
    taps = [
        xp[:, ky * dilation : ky * dilation + stride * (ho - 1) + 1 : stride,
           kx * dilation : kx * dilation + stride * (wo - 1) + 1 : stride]
        for ky in range(k)
        for kx in range(k)
    ]
    return torch.stack(taps, dim=3).reshape(n, ho, wo, k * k * c)


def conv2d_int8(xq: torch.Tensor, wq: torch.Tensor, k: int, stride: int = 1,
                dilation: int = 1) -> torch.Tensor:
    """``(N, H, W, C)`` int8 conv ``wq`` (``(O, k*k*C)`` int8, taps in
    (ky, kx, c) order) -> ``(N, Ho, Wo, O)`` int32."""
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise ValueError(f"expected int8 operands, got {xq.dtype} and {wq.dtype}")
    if k == 1:
        cols = xq[:, ::stride, ::stride] if stride > 1 else xq
        cols = cols.contiguous()
    else:
        cols = im2col(xq, k, stride, dilation)
    n, ho, wo, kk = cols.shape
    if kk != wq.shape[1]:
        raise ValueError(f"input gives {kk} taps*channels, the kernel takes {wq.shape[1]}")
    acc = int_mm(cols.reshape(n * ho * wo, kk), wq.t())
    return acc.reshape(n, ho, wo, wq.shape[0])


def _grouped_shapes(xq: torch.Tensor, wq: torch.Tensor, k: int, stride: int, groups: int):
    """(Ho, Wo) of the grouped conv, after checking what both versions take."""
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise ValueError(f"expected int8 operands, got {xq.dtype} and {wq.dtype}")
    if xq.dim() != 4 or wq.dim() != 2:
        raise ValueError(f"expected (N, H, W, C) and (O, k*k*C/groups), got "
                         f"{tuple(xq.shape)} and {tuple(wq.shape)}")
    n, h, w, c = xq.shape
    o = wq.shape[0]
    if groups < 1 or c % groups or o % groups:
        raise ValueError(f"{groups} groups do not divide {c} input and {o} output channels")
    if k < 1 or k % 2 == 0 or stride not in (1, 2):
        raise ValueError(f"kernel {k} and stride {stride}: expected an odd k and stride 1 or 2")
    if wq.shape[1] != k * k * (c // groups):
        raise ValueError(f"the kernel takes {wq.shape[1]} taps*channels, the input gives "
                         f"{k * k * (c // groups)} a group")
    pad = k // 2
    return (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1


def grouped_conv2d_int32(xq: torch.Tensor, wq: torch.Tensor, k: int, stride: int = 1,
                         groups: int = 1) -> torch.Tensor:
    """The grouped conv, exact in int32: in floating point, whose integer
    products and partial sums (at most ``k*k*C/groups * 127^2``) it holds
    exactly, rounded back to int32. On the CPU that is float32 while the
    sums stay below 2^24 (every timm conv: 432 terms at most), which
    oneDNN's direct conv runs about 100x faster than float64; on the card,
    float64, whose error stays far below 0.5 whatever algorithm cuDNN
    picks."""
    _grouped_shapes(xq, wq, k, stride, groups)
    o, c = wq.shape[0], xq.shape[3]
    exact32 = k * k * (c // groups) * 127 * 127 < 2 ** 24
    dt = torch.float32 if xq.device.type == "cpu" and exact32 else torch.float64
    weight = wq.to(dt).reshape(o, k, k, c // groups).permute(0, 3, 1, 2)
    y = F.conv2d(xq.to(dt).permute(0, 3, 1, 2), weight, stride=stride, padding=k // 2,
                 groups=groups)
    return y.permute(0, 2, 3, 1).round().to(torch.int32).contiguous()


def _check_fold(wq: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> None:
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"G1 folds into bfloat16 or float32, not {dtype}")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (wq.shape[0],):
        raise ValueError(f"expected a float32 ({wq.shape[0]},) scale, got {scale.dtype} "
                         f"{tuple(scale.shape)}")


def grouped_conv2d_int8_plain(xq: torch.Tensor, wq: torch.Tensor, k: int, stride: int,
                              groups: int, scale: torch.Tensor,
                              dtype: torch.dtype) -> torch.Tensor:
    """G1's plain version: the exact int32 grouped conv
    (``grouped_conv2d_int32``), then the fold ``(acc.float() *
    scale).to(dtype)``."""
    _check_fold(wq, scale, dtype)
    return (grouped_conv2d_int32(xq, wq, k, stride, groups).float() * scale).to(dtype)


_PATHS = {0: "general", 1: "depthwise", 2: "depthwise-bytes", 3: "grouped-mma"}
_CUDA_INVALID_VALUE = 1  # cudaErrorInvalidValue: what the launcher returns for a shape it refuses


def _lib():
    lib = _cuda_build.load("grouped_conv_s8")
    if lib.grouped_conv_s8.argtypes is None:
        lib.grouped_conv_s8.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        lib.grouped_conv_s8.restype = ctypes.c_int
        lib.grouped_conv_s8_path.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10
        lib.grouped_conv_s8_path.restype = ctypes.c_int
    return lib


def g1_path(xq: torch.Tensor, wq: torch.Tensor, k: int, stride: int, groups: int) -> str:
    """The path G1's launcher takes for these CUDA operands and a fresh
    output: ``depthwise``, ``depthwise-bytes`` (byte staging), ``grouped-mma``
    or ``general`` (builds the kernel; launches nothing)."""
    ho, wo = _grouped_shapes(xq, wq, k, stride, groups)
    n, h, w, c = xq.shape
    path = _lib().grouped_conv_s8_path(xq.data_ptr(), wq.data_ptr(), 0, n, h, w, c, wq.shape[0],
                                       k, stride, groups, ho, wo)
    return _PATHS[path]


def grouped_conv2d_int8(xq: torch.Tensor, wq: torch.Tensor, k: int, stride: int, groups: int,
                        scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``(N, H, W, C)`` int8 conv ``wq`` (``(O, k*k*C/groups)`` int8, taps
    in (ky, kx, c) order), zero padding ``k // 2``, ``groups`` groups, folded
    by the ``(O,)`` float32 ``scale`` -> ``(N, Ho, Wo, O)`` in ``dtype``
    (bfloat16 or float32): G1 on the card, its plain version on the CPU."""
    ho, wo = _grouped_shapes(xq, wq, k, stride, groups)
    _check_fold(wq, scale, dtype)
    devices = {xq.device, wq.device, scale.device}
    if devices == {torch.device("cpu")}:
        return grouped_conv2d_int8_plain(xq, wq, k, stride, groups, scale, dtype)
    if xq.device.type != "cuda" or len(devices) != 1:
        raise ValueError(f"unsupported devices {xq.device}, {wq.device} and {scale.device}")
    if not (xq.is_contiguous() and wq.is_contiguous() and scale.is_contiguous()):
        raise ValueError("G1 takes contiguous (N, H, W, C) inputs, (O, K) weights and scales")
    n, h, w, c = xq.shape
    o = wq.shape[0]
    out = torch.empty((n, ho, wo, o), dtype=dtype, device=xq.device)
    with torch.cuda.device(xq.device):
        err = _lib().grouped_conv_s8(xq.data_ptr(), wq.data_ptr(), scale.data_ptr(),
                                     out.data_ptr(), n, h, w, c, o, k, stride, groups, ho, wo,
                                     int(dtype == torch.bfloat16),
                                     torch.cuda.current_stream(xq.device).cuda_stream)
    if err == _CUDA_INVALID_VALUE:
        raise ValueError(f"G1 does not take {tuple(xq.shape)} x {tuple(wq.shape)} (k {k}, stride "
                         f"{stride}, {groups} groups): a grid too large for its "
                         f"{g1_path(xq, wq, k, stride, groups)} path")
    if err != 0:
        raise RuntimeError(f"grouped_conv_s8 kernel launch failed: CUDA error {err}")
    grouped_conv2d_int8.launches += 1
    return out


grouped_conv2d_int8.launches = 0
