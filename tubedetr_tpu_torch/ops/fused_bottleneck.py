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

The kernel's tiling (``tile_plan``, ``band_span``, ``tap_offsets``): the 3x3
runs on a zero-padded grid, each frame row ``tw = W + 2d`` wide and ``d``
zero rows between frames (and above the first), so a tap is a constant offset
``ky*d*tw + kx*d``. Bands are runs of ``64 * tiles`` grid positions across
the whole batch; conv1 runs over the compact rows of ``xq`` whose ``q1`` a
band needs. The kernel computes the same plan (``fused_bottleneck_plan``);
``tests/test_torch_fused_bottleneck.py`` rebuilds the block from this plan
in plain PyTorch. A width whose q1 tile does not fit shared memory runs in
column strips that overlap by ``d`` columns (``column_strips``), one launch
each.

The same kernel runs probe P5 (``ops/probe_bottleneck.py:flat_bottleneck``)
on frames stored ``frame_rows`` apart (``H*W`` real rows, then pad rows):
``band_span``, ``compact_to_grid`` and ``grid_to_compact`` take that stride,
a pad row maps to no grid position (-1), and ``pad_frames_of_band`` names the
frames whose pad rows of ``out`` a band writes 0. Its ``im2col`` variant adds
a patch buffer to the plan (``tile_plan(..., im2col=True)``).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from tubedetr_tpu_torch.ops import _cuda_build
from tubedetr_tpu_torch.ops.int8_conv import im2col, int_mm

KERNEL_PLANES = (64, 128, 256, 512)  # mid channels P the kernel is built for
CHANNEL_BYTES = 128  # C is a multiple of one 128-byte TMA slice of K
SMEM_LIMIT = 227 * 1024  # opt-in shared memory of one block on sm_90
TILE = 64  # grid positions of one wgmma tile
RING_SLOT = 256 * 128  # one ring stage: 256 rows x 128 bytes of K
NC1_MAX = 128  # conv1's output channels a pass (beside 128 rows of x in a stage)
MAX_STAGES, MIN_STAGES, MAX_TILES = 3, 2, 16
SMEM_ALIGN, SMEM_BARRIERS = 1024, 128
PATCH_SLOTS = 4  # im2col: two slots of 64 positions x one slice of K a consumer warpgroup


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


@dataclass(frozen=True)
class TilePlan:
    """How K2 tiles a width ``w`` with ``p`` mid channels at ``dilation``."""

    w: int
    p: int
    dilation: int
    stages: int  # ring stages of RING_SLOT bytes
    tiles: int  # 64-position wgmma tiles a band
    im2col: bool = False  # P5's im2col variant: the patch slots in shared memory

    @property
    def tw(self) -> int:
        """Padded width: ``d`` zero columns each side."""
        return self.w + 2 * self.dilation

    @property
    def band(self) -> int:
        """Grid positions a band."""
        return TILE * self.tiles

    @property
    def centre(self) -> int:
        """Offset of the centre tap, ``d*tw + d``."""
        return self.dilation * self.tw + self.dilation

    @property
    def q1_rows(self) -> int:
        """Positions of the q1 tile: the band and a halo of ``centre`` each side."""
        return _q1_rows(self.tiles, self.tw, self.dilation)

    @property
    def smem_bytes(self) -> int:
        return _smem(self.p, self.stages, self.tiles, self.q1_rows, self.im2col)

    @property
    def band_rows(self) -> float:
        """Image rows a band spans (its positions over the padded width)."""
        return self.band / self.tw

    def tap_offsets(self):
        """q1 grid offset of each tap (``ky*3 + kx``) from the output position."""
        d, tw = self.dilation, self.tw
        return tuple(ky * d * tw + kx * d for ky in range(3) for kx in range(3))


def _q1_rows(tiles: int, tw: int, d: int) -> int:
    return (TILE * tiles + 2 * d * tw + 2 * d + 7) // 8 * 8


def _smem(p: int, stages: int, tiles: int, q1_rows: int, im2col: bool = False) -> int:
    """Alignment slack, the ring, its barriers, the q1 tile, one 64 x P q2
    tile per busy consumer warpgroup; for im2col the patch slots, each 64
    positions of one 128-byte slice of K (64 bytes at P=64)."""
    patch = PATCH_SLOTS * TILE * min(p, 128) if im2col else 0
    return (SMEM_ALIGN + stages * RING_SLOT + SMEM_BARRIERS + q1_rows * p + TILE * min(tiles, 2) * p
            + patch)


def _tiles_fitting(w: int, p: int, d: int, stages: int, im2col: bool) -> int:
    tw = w + 2 * d
    fits = [t for t in range(1, MAX_TILES + 1)
            if _smem(p, stages, t, _q1_rows(t, tw, d), im2col) <= SMEM_LIMIT]
    return max(fits, default=0)


def tile_plan(w: int, p: int, dilation: int, im2col: bool = False):
    """K2's plan for a width, mid channels and dilation (``im2col``: P5's
    variant, with its patch), as the kernel makes it (``make_plan`` in
    ``csrc/fused_bottleneck.cu``): 3 ring stages if that leaves a band of at
    least 4 tiles, else 2 stages and the most tiles that fit. None for a
    shape the kernel does not take. The flat layout of P5 does not change
    it: the q1 tile spans grid positions whatever the frame stride of x."""
    if p not in KERNEL_PLANES or w < 1 or dilation < 1 or w > 1 << 20 or dilation > 1 << 20:
        return None
    for stages in range(MAX_STAGES, MIN_STAGES, -1):
        tiles = _tiles_fitting(w, p, dilation, stages, im2col)
        if tiles >= 4:
            return TilePlan(w, p, dilation, stages, tiles, im2col)
    tiles = _tiles_fitting(w, p, dilation, MIN_STAGES, im2col)
    return TilePlan(w, p, dilation, MIN_STAGES, tiles, im2col) if tiles else None


def grid_positions(n: int, h: int, plan: TilePlan) -> int:
    """Positions of the output grid: ``n`` frames of ``h + d`` rows of ``tw``."""
    return n * (h + plan.dilation) * plan.tw


def real_before(q: int, n: int, h: int, plan: TilePlan) -> int:
    """Real (in-frame) positions of the q1 grid before grid index ``q``: the
    compact row of ``xq`` at or after ``q``. The q1 grid has ``d`` zero rows
    on top, then per frame ``h`` rows and ``d`` separator rows, each ``tw``
    wide with the pixels at columns ``[d, d + w)``."""
    d, w, hd = plan.dilation, plan.w, h + plan.dilation
    u, col = q // plan.tw - d, q % plan.tw
    if u < 0:
        return 0
    f, hh = u // hd, u % hd
    if f >= n:
        return n * h * w
    before = (f * h + min(hh, h)) * w
    return before + min(max(col - d, 0), w) if hh < h else before


def compact_to_grid(px, h: int, plan: TilePlan, frame_rows=None):
    """q1 grid index of row ``px`` of ``xq`` as ``(N*frame_rows, C)``
    (``frame_rows`` is ``H*W`` unless the frames are stored further apart),
    or -1 for a pad row past a frame's ``H*W`` real rows."""
    d, w = plan.dilation, plan.w
    fs = frame_rows or h * w
    f, rem = px // fs, px % fs
    q = (f * (h + d) + d + rem // w) * plan.tw + d + rem % w
    if torch.is_tensor(px):
        return torch.where(rem < h * w, q, torch.full_like(q, -1))
    return q if rem < h * w else -1


def grid_to_compact(o, h: int, plan: TilePlan, frame_rows=None):
    """Row of ``xq`` (frames ``frame_rows`` apart, ``H*W`` by default) of
    output grid position ``o``, or -1 on a padding column or separator row."""
    d, w, hd = plan.dilation, plan.w, h + plan.dilation
    r, ww = o // plan.tw, o % plan.tw
    f, hh = r // hd, r % hd
    px = f * (frame_rows or h * w) + hh * w + ww
    if torch.is_tensor(o):
        return torch.where((ww < w) & (hh < h), px, torch.full_like(px, -1))
    return px if ww < w and hh < h else -1


def flat_row(c: int, h: int, w: int, frame_rows) -> int:
    """Row of the ``c``-th real pixel when frames are ``frame_rows`` apart."""
    return c if not frame_rows else c // (h * w) * frame_rows + c % (h * w)


def band_span(plan: TilePlan, n: int, h: int, b: int, variant: str = "full", frame_rows=None):
    """Band ``b``: ``(m0, bm, q_lo, p_lo, p_hi)``: its first output grid
    position, its positions, the q1 grid index of its q1 tile's first
    position, and the rows ``[p_lo, p_hi)`` of ``xq`` conv1 runs over (the
    band and its halo of ``centre`` each side; ``noshift`` and ``convonly``:
    the band alone, the tile starting at the centre). With ``frame_rows``
    (the flat layout) the rows run from the first real pixel to the last,
    the pad rows between frames included."""
    m0 = b * plan.band
    bm = min(plan.band, grid_positions(n, h, plan) - m0)
    halo = variant in ("full", "im2col")
    q_lo = m0 if halo else m0 + plan.centre
    ext = bm + 2 * plan.centre if halo else bm
    c_lo, c_hi = real_before(q_lo, n, h, plan), real_before(q_lo + ext, n, h, plan)
    p_lo = flat_row(c_lo, h, plan.w, frame_rows)
    p_hi = flat_row(c_hi - 1, h, plan.w, frame_rows) + 1 if c_hi > c_lo else p_lo
    return m0, bm, q_lo, p_lo, p_hi


def pad_frames_of_band(plan: TilePlan, n: int, h: int, b: int):
    """The frames whose pad rows of ``out`` band ``b`` writes 0 in the flat
    layout: those whose last real pixel's output grid position is in the
    band (one band a frame)."""
    m0, bm, _, _, _ = band_span(plan, n, h, b)
    last = (h - 1) * plan.tw + plan.w - 1
    fgrid = (h + plan.dilation) * plan.tw
    return [f for f in range(n) if m0 <= f * fgrid + last < m0 + bm]


def n_bands(plan: TilePlan, n: int, h: int) -> int:
    return -(-grid_positions(n, h, plan) // plan.band)


def tma_box_bytes(plan: TilePlan, n: int, h: int, c: int) -> int:
    """A model of the bytes K2's TMA loads ask for in one launch, counted
    from the tiling (no counter on the card measures it): the in-bounds part
    of every box, zero fill not counted. Every pair of 64-position tiles
    streams w2 and w3 once; every pair of conv1 tiles streams w1 once and its
    128 rows of x once a pass of ``NC1_MAX`` output channels."""
    p = plan.p
    rows = n * h * plan.w
    x_passes = p // min(p, NC1_MAX)
    total = 0
    for b in range(n_bands(plan, n, h)):
        _, bm, _, p_lo, p_hi = band_span(plan, n, h, b)
        for row0 in range(p_lo, p_hi, 2 * TILE):
            total += p * c + x_passes * c * min(2 * TILE, rows - row0)
        total += -(-bm // (2 * TILE)) * (c * p + 9 * p * p)
    return total


def column_strips(w: int, p: int, dilation: int):
    """The column strips K2 runs a frame of width ``w`` in, as ``(s0, s1, c0,
    c1)``: a launch on input columns ``[s0, s1)`` whose output columns ``[c0,
    c1)`` are kept. One strip where the width's plan fits; else the fewest
    strips of equal width whose inputs, ``dilation`` columns wider on each
    inner side, fit (at P=512 and d=2, the q1 tile of a width above 43 does
    not fit beside the ring). The 3x3 at a kept column reads only columns of
    its strip's input or the zero border, so the strips' outputs are exact.
    None if not even one column fits."""
    if tile_plan(w, p, dilation):
        return [(0, w, 0, w)]
    if tile_plan(min(w, 1 + 2 * dilation), p, dilation) is None:
        return None
    for k in range(2, w + 1):
        step = -(-w // k)
        strips = [(max(c0 - dilation, 0), min(c0 + step + dilation, w), c0, min(c0 + step, w))
                  for c0 in range(0, w, step)]
        if all(tile_plan(s1 - s0, p, dilation) for s0, s1, _, _ in strips):
            return strips
    return None  # unreachable: one column a strip fits


def in_strips(xq: torch.Tensor, strips, block) -> torch.Tensor:
    """``block`` (an ``(N, H, W', C)`` -> same-shape function) over the
    column ``strips`` of ``xq``, the kept columns of each assembled."""
    if len(strips) == 1:
        return block(xq)
    out = torch.empty_like(xq)
    for s0, s1, c0, c1 in strips:
        out[:, :, c0:c1] = block(xq[:, :, s0:s1].contiguous())[:, :, c0 - s0:c1 - s0]
    return out


def kernel_plan(w: int, p: int, dilation: int, im2col: bool = False):
    """The plan the built kernel makes (``fused_bottleneck_plan``), as
    ``(tw, stages, tiles, q1_rows, smem_bytes)``, or None: what a card test
    holds ``tile_plan`` to."""
    fn = _cuda_build.load("fused_bottleneck").fused_bottleneck_plan
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    smem = fn(w, p, dilation, int(im2col), out)
    return None if smem < 0 else (*out, smem)


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
    if c % 64 or p % 64:
        raise ValueError(f"the kernels take channel counts that are multiples of 64; got C={c}, P={p}")
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


def check_kernel(xq: torch.Tensor, fold: BottleneckFold, n: int, h: int, plan) -> None:
    """Raise on what K2's kernel does not take on the card: its channel
    counts, a plan that does not fit (``plan`` None), 32-bit grid positions
    and rows, bases that are not 16-byte aligned (TMA)."""
    c, p = fold.channels
    if p not in KERNEL_PLANES or c % CHANNEL_BYTES:
        raise ValueError(
            f"K2 takes channel counts that are multiples of 64 with P in {KERNEL_PLANES} and "
            f"C a multiple of {CHANNEL_BYTES}; got C={c}, P={p}"
        )
    if plan is None:
        raise ValueError(
            f"K2's q1 tile for a column with {p} channels does not fit {SMEM_LIMIT} bytes of "
            f"shared memory beside its ring"
        )
    frame_rows = xq.numel() // (c * n) if n else 0
    if (grid_positions(n, h, plan) + 2 * plan.band + 2 * plan.centre >= 2**31
            or (n + 1) * frame_rows >= 2**31):
        raise ValueError(f"{n} frames of height {h} exceed the kernel's 32-bit grid positions")
    for name, t in (("xq", xq), ("fold.w1", fold.w1), ("fold.w2", fold.w2), ("fold.w3", fold.w3)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start 16-byte aligned (TMA)")


def check_input(xq: torch.Tensor, fold: BottleneckFold, dilation: int) -> None:
    """Raise on a stream, fold or dilation that K2 does not take: on the CPU
    (its plain version) or on the card (the kernel)."""
    check_stream(xq, fold)
    if dilation < 1:
        raise ValueError(f"dilation must be >= 1, got {dilation}")
    if xq.device.type == "cpu":
        return
    _, p = fold.channels
    n, h, w, _ = xq.shape
    strips = column_strips(w, p, dilation)  # None: not one column fits, or P is not built
    check_kernel(xq, fold, n, h,
                 strips and tile_plan(max(s1 - s0 for s0, s1, _, _ in strips), p, dilation))


def fused_bottleneck_block(xq: torch.Tensor, fold: BottleneckFold, dilation: int = 1):
    """One fused stride-1 bottleneck on the int8 stream ``(N, H, W, C)``:
    returns ``(out int8 (N, H, W, C), fold.so)``. On the card, one launch a
    column strip (``column_strips``: one, unless the width's q1 tile does
    not fit)."""
    check_input(xq, fold, dilation)
    if xq.device.type == "cpu":
        return fused_bottleneck_plain(xq, fold, dilation), fold.so

    def launch(x):
        out = torch.empty_like(x)
        launch_k2(x, out, fold, dilation)
        fused_bottleneck_block.launches += 1
        return out

    return in_strips(xq, column_strips(xq.shape[2], fold.channels[1], dilation), launch), fold.so


fused_bottleneck_block.launches = 0
