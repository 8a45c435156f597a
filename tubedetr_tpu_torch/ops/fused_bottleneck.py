"""K2: one whole int8 stride-1 ResNet bottleneck in one launch.

Counterpart of ``tubedetr_tpu/ops/fused_bottleneck.py``. On the int8
residual stream ``xq`` (scale ``sx``) the block computes, with per-channel
f32 folds and s8 x s8 -> s32 products::

    q1  = clip(round(relu(conv1(xq) * a1 + b1)), 0, 127)          1x1
    q2  = clip(round(relu(conv2(q1) * a2 + b2)), 0, 127)          3x3, dilation d, zero border
    out = clip(round(relu(conv3(q2) * a3 + b3 + xq * s_id)), 0, 127)

``fold_bottleneck`` quantizes the float kernels per out-channel and folds
the FrozenBN scale/shift and the calibrated activation scales into
``a1..b3``, ``s_id`` and the output scale ``so``, in the JAX package's f32
operation order. ``fused_bottleneck_block`` launches the CUDA kernel of
``csrc/fused_bottleneck.cu`` for a tensor on the card and counts each launch
in ``fused_bottleneck_block.launches``; for a tensor on the CPU it runs
``fused_bottleneck_plain`` (three ``torch._int_mm`` products, the 3x3 as an
int8 im2col). A CUDA tensor never reaches the plain version.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from tubedetr_tpu_torch.ops import _cuda_build
from tubedetr_tpu_torch.ops.int8_conv import im2col, int_mm

CHANNEL_GROUP = 64  # the kernel's warp tile spans 64 output channels
SMEM_LIMIT = 227 * 1024  # opt-in shared memory of one block on sm_90
SMEM_PAD = 16  # bytes added to each pixel's channel row in shared memory
BAND_ROWS = 2  # output rows per CUDA block (kR in the kernel)


def quantize_weight(kernel: torch.Tensor):
    """Per-out-channel symmetric int8: HWIO (or (I, O)) kernel -> (int8 of
    the same shape, (O,) f32 scales)."""
    kernel = kernel.float()
    axes = tuple(range(kernel.dim() - 1))
    sw = torch.clamp_min(torch.amax(kernel.abs(), dim=axes), 1e-12) / 127.0
    wq = torch.clamp(torch.round(kernel / sw), -127, 127).to(torch.int8)
    return wq, sw


@dataclass
class BottleneckFold:
    """What K2 reads besides the stream: int8 weights laid out output
    channel first (each row contiguous along the reduction), the f32 folds
    and the output scale."""

    w1: torch.Tensor  # (P, C) int8: conv1, [out][in]
    w2: torch.Tensor  # (9, P, P) int8: conv2, [tap = ky*3 + kx][out][in]
    w3: torch.Tensor  # (C, P) int8: conv3, [out][in]
    a1: torch.Tensor  # (P,) f32
    b1: torch.Tensor
    a2: torch.Tensor  # (P,)
    b2: torch.Tensor
    a3: torch.Tensor  # (C,)
    b3: torch.Tensor
    sid: torch.Tensor  # (1,) f32: sx / so
    so: torch.Tensor  # () f32: the output stream's scale

    @property
    def channels(self):
        return self.w3.shape[0], self.w1.shape[0]  # (C, P)


def fold_bottleneck(sx, kernels: dict, norms: dict, act_max2, act_max3, out_max) -> BottleneckFold:
    """Quantize ``kernels`` (HWIO float: ``conv1`` (1,1,C,P), ``conv2``
    (3,3,P,P), ``conv3`` (1,1,P,C)) and fold ``norms`` (``bn1..bn3``:
    (scale, shift)) with the stream scale ``sx`` and the calibrated maxima,
    as ``fused_bottleneck_block`` of the JAX package does."""
    f32 = torch.float32
    k1, k2, k3 = (kernels[f"conv{i}"].float() for i in (1, 2, 3))
    w1q, sw1 = quantize_weight(k1[0, 0])  # (C, P)
    w2q, sw2 = quantize_weight(k2)  # (3, 3, P, P)
    w3q, sw3 = quantize_weight(k3[0, 0])  # (P, C)
    (g1, c1), (g2, c2), (g3, c3) = (norms[f"bn{i}"] for i in (1, 2, 3))
    dev = k1.device
    sx = torch.as_tensor(sx, dtype=f32, device=dev)
    s2 = torch.clamp_min(torch.as_tensor(act_max2, dtype=f32, device=dev), 1e-6) / 127.0
    s3 = torch.clamp_min(torch.as_tensor(act_max3, dtype=f32, device=dev), 1e-6) / 127.0
    so = torch.clamp_min(torch.as_tensor(out_max, dtype=f32, device=dev), 1e-6) / 127.0
    p = w1q.shape[1]
    return BottleneckFold(
        w1=w1q.t().contiguous(),
        w2=w2q.reshape(9, p, p).transpose(1, 2).contiguous(),
        w3=w3q.t().contiguous(),
        a1=((sx * sw1 * g1) / s2).to(f32).contiguous(),
        b1=(c1 / s2).to(f32).contiguous(),
        a2=((s2 * sw2 * g2) / s3).to(f32).contiguous(),
        b2=(c2 / s3).to(f32).contiguous(),
        a3=((s3 * sw3 * g3) / so).to(f32).contiguous(),
        b3=(c3 / so).to(f32).contiguous(),
        sid=(sx / so).to(f32).reshape(1),
        so=so,
    )


def _requant(y: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(torch.clamp_min(y, 0.0)), 0, 127).to(torch.int8)


def fused_bottleneck_plain(xq: torch.Tensor, fold: BottleneckFold, dilation: int = 1) -> torch.Tensor:
    """Plain PyTorch version of K2: ``torch._int_mm`` for conv1 and conv3, an
    int8 im2col over the zero-bordered ``q1`` and ``torch._int_mm`` for the
    3x3, the f32 epilogues in K2's (and the JAX package's) operation order."""
    n, h, w, c = xq.shape
    p = fold.w1.shape[0]
    rows = xq.reshape(n * h * w, c)
    acc1 = int_mm(rows, fold.w1.t())
    q1 = _requant(acc1.float() * fold.a1 + fold.b1).reshape(n, h, w, p)
    cols = im2col(q1, 3, 1, dilation).reshape(n * h * w, 9 * p)
    w2 = fold.w2.transpose(0, 1).reshape(p, 9 * p)  # [out][tap, in]
    acc2 = int_mm(cols, w2.t())
    q2 = _requant(acc2.float() * fold.a2 + fold.b2)
    acc3 = int_mm(q2, fold.w3.t())
    y3 = acc3.float() * fold.a3 + fold.b3 + rows.float() * fold.sid
    return _requant(y3).reshape(n, h, w, c)


def smem_bytes(w: int, p: int, dilation: int) -> int:
    """Shared memory of one K2 block: the zero-bordered ``q1`` tile of
    ``BAND_ROWS + 2d`` rows and the ``q2`` tile of ``BAND_ROWS`` rows. Two
    rows a block: conv1 recomputes a halo of ``dilation`` rows on each side,
    so at d=1 it does 2x the band's conv1 work (3x with one row a block)."""
    r, ps = BAND_ROWS, p + SMEM_PAD
    return ((r + 2 * dilation) * (w + 2 * dilation) + r * w) * ps


def blocks_per_sm(w: int, p: int, dilation: int) -> int:
    """K2 blocks resident on one SM of the current card for a band of width
    ``w`` with ``p`` mid channels, as the CUDA occupancy calculator gives it
    (registers, shared memory and threads of the built kernel)."""
    fn = _cuda_build.load("fused_bottleneck").fused_bottleneck_blocks_per_sm
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    blocks = fn(w, p, dilation)
    if blocks < 0:
        raise RuntimeError("the CUDA occupancy query for K2 failed")
    return blocks


def launch_fold_kernel(lib: str, entry: str, xq, out, fold: BottleneckFold, dims) -> None:
    """Launch ``entry`` of ``csrc/<lib>.cu`` on the current CUDA stream. Every
    bottleneck entry (K2 and the probe variants of ``ops/probe_bottleneck.py``)
    takes the int8 input and output, the fold's nine tensors and ``sid``, the
    six ints ``dims``, then the stream."""
    fn = getattr(_cuda_build.load(lib), entry)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        err = fn(
            xq.data_ptr(), out.data_ptr(), fold.w1.data_ptr(), fold.w2.data_ptr(),
            fold.w3.data_ptr(), fold.a1.data_ptr(), fold.b1.data_ptr(), fold.a2.data_ptr(),
            fold.b2.data_ptr(), fold.a3.data_ptr(), fold.b3.data_ptr(), fold.sid.data_ptr(),
            *dims, stream,
        )
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")


def launch_k2(xq, out, fold: BottleneckFold, dilation: int, entry: str = "fused_bottleneck_s8") -> None:
    """Launch ``entry`` of ``csrc/fused_bottleneck.cu``: K2, or one of its
    probe variants, on the ``(N, H, W, C)`` stream."""
    n, h, w, c = xq.shape
    launch_fold_kernel("fused_bottleneck", entry, xq, out, fold,
                       (n, h, w, c, fold.w1.shape[0], dilation))


def check_fold(fold: BottleneckFold, device: torch.device) -> None:
    """Raise on a fold that the CUDA kernels do not take on ``device``."""
    c, p = fold.channels
    if c % CHANNEL_GROUP or p % CHANNEL_GROUP:
        raise ValueError(
            f"K2 takes channel counts that are multiples of {CHANNEL_GROUP}; got C={c}, P={p}"
        )
    for name in ("w1", "w2", "w3", "a1", "b1", "a2", "b2", "a3", "b3", "sid"):
        t = getattr(fold, name)
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"fold.{name} must be contiguous on {device}")


def check_stream(xq: torch.Tensor, fold: BottleneckFold, layout: str = "N, H, W") -> None:
    """Raise on an int8 stream ``(layout..., C)`` that the kernels reading
    ``fold`` do not take: any on the CPU (their plain versions), contiguous
    and beside its fold on the card."""
    c, _ = fold.channels
    if xq.dtype != torch.int8 or xq.dim() != layout.count(",") + 2 or xq.shape[-1] != c:
        raise ValueError(f"expected ({layout}, {c}) int8, got {tuple(xq.shape)} {xq.dtype}")
    if xq.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {xq.device}")
    if xq.device.type == "cuda":
        if not xq.is_contiguous():
            raise ValueError(f"the int8 stream must be contiguous ({layout}, C)")
        check_fold(fold, xq.device)


def check_input(xq: torch.Tensor, fold: BottleneckFold, dilation: int) -> None:
    """Raise on a stream, fold or dilation that K2 does not take: on the CPU
    (its plain version) or on the card (the kernel)."""
    check_stream(xq, fold)
    if dilation < 1:
        raise ValueError(f"dilation must be >= 1, got {dilation}")
    if xq.device.type == "cpu":
        return
    _, p = fold.channels
    n, _, w, _ = xq.shape
    if n > 65535:
        raise ValueError("at most 65535 frames per launch")
    if smem_bytes(w, p, dilation) > SMEM_LIMIT:
        raise ValueError(
            f"K2's band of {BAND_ROWS} rows of width {w} with {p} channels at dilation "
            f"{dilation} needs {smem_bytes(w, p, dilation)} bytes of shared memory, "
            f"more than {SMEM_LIMIT}"
        )


def fused_bottleneck_block(xq: torch.Tensor, fold: BottleneckFold, dilation: int = 1):
    """One fused stride-1 bottleneck on the int8 stream ``(N, H, W, C)``:
    returns ``(out int8 (N, H, W, C), fold.so)``."""
    check_input(xq, fold, dilation)
    if xq.device.type == "cpu":
        return fused_bottleneck_plain(xq, fold, dilation), fold.so
    out = torch.empty_like(xq)
    launch_k2(xq, out, fold, dilation)
    fused_bottleneck_block.launches += 1
    return out, fold.so


fused_bottleneck_block.launches = 0
