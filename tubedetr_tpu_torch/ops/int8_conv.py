"""s8 x s8 -> s32 convolutions for the unfused int8 bottleneck blocks.

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
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

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
