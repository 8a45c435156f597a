"""K1, fused resize (+ crop) + normalize, against the JAX package.

On the CPU the port's wrapper runs K1's plain version (two dense f32
contractions, then the affine). It is held to the Pallas kernel in interpret
mode and to the f32 einsum path of ``ops/preprocess.py`` in the three cases
of ``tests/test_pallas_preprocess.py``: atol 1e-4 for f32 out, one bf16 ulp
of the f32 reference for bf16 out. The gather tables the CUDA kernel reads
are held to ``_interp_matrix``, clamped borders included, and the kernel's
schedule (bands of rows, staged source bytes, 8-element chunks of the flat
output, the zero pad) is rebuilt in plain PyTorch from those tables
(``kernel_rebuild``) and held to the plain version and the Pallas kernel. The
padded output is held to the JAX pipeline's host pad. The CUDA kernel itself
is held to the plain version in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_threads import one_torch_thread  # noqa: F401 - autouse
from tubedetr_tpu.ops.pallas_preprocess import resize_normalize_fused, resize_normalize_pallas
from tubedetr_tpu.ops.preprocess import _interp_matrix as jax_interp_matrix
from tubedetr_tpu.ops.preprocess import resize_normalize as jax_resize_normalize
from tubedetr_tpu_torch.ops.preprocess import _interp_matrix, gather_taps, norm_affine
from tubedetr_tpu_torch.ops.resize_normalize import (
    CHUNK,
    SMEM_TARGET,
    k1_schedule,
    resize_normalize,
    resize_normalize_plain,
)

CASES = {  # (frames shape, out (h, w), crop, out dtype), as in test_pallas_preprocess.py
    "plain": ((2, 36, 48, 3), (24, 32), None, torch.float32),
    "crop": ((1, 40, 40, 3), (16, 16), (5, 8, 30, 24), torch.float32),
    "bf16": ((1, 16, 16, 3), (8, 8), None, torch.bfloat16),
}


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """Spacing of bfloat16 numbers at |x| (8 significant bits)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


def staged(row: np.ndarray, d: int, slot_bytes: int) -> torch.Tensor:
    """A source row staged as the kernel stages it, as f32: byte ``i`` at
    ``d + i`` of a slot of ``slot_bytes`` (``d`` its address mod 16; the rest
    never written, 0xEE here)."""
    buf = np.full(slot_bytes, 0xEE, np.uint8)
    buf[d:d + len(row)] = row
    return torch.from_numpy(buf.astype(np.float32))


def kernel_rebuild(frames, out_h, out_w, crop=None, pad_to=None, base=0):
    """K1 rebuilt in plain PyTorch from the kernel's schedule
    (``k1_schedule``): bands of ``rows_per_block`` output rows of a frame;
    a band stages the bytes ``[x_lo, x_lo + x_len)`` of each of its source
    rows (``band_src``) at their address mod 16 (``base``: the frames'
    address mod 16); each output row reads the two staged rows its slots
    name at its column taps (rows, then columns, then the affine, in f32;
    0 past the resized frame) into a row buffer that holds element ``e`` at
    ``e + row0 % 8``, then copies the 8-element chunks at 8-aligned indices
    of the flat output that touch the row, each writing only its row's
    elements. Returns the f32 output; every element is written once."""
    n, ih, iw, _ = frames.shape
    ph, pw = pad_to or (out_h, out_w)
    sched = k1_schedule(ih, iw, out_h, out_w, crop, pad_to)
    assert sched.smem_bytes <= SMEM_TARGET or sched.rows_per_block == 1
    assert sched.band_src.shape == (-(-ph // sched.rows_per_block), sched.slots)
    slot_bytes = (sched.x_len + 30) // 16 * 16
    obuf = ((3 * pw + 7) // 8 + 1) * 8
    assert sched.smem_bytes == (16 * out_w + 16 * sched.rows_per_block + 2 * 4 * obuf
                                + sched.slots * slot_bytes)
    wy = torch.from_numpy(sched.rows[:, 2:].copy().view(np.float32))
    wx = torch.from_numpy(sched.cols[:, 2:].copy().view(np.float32))
    scale, shift = (torch.from_numpy(a) for a in norm_affine())
    src = frames.reshape(n, ih, iw * 3).numpy()
    x_lo, x_len = sched.x_lo, sched.x_len
    ow3, pw3 = out_w * 3, pw * 3
    e = torch.arange(ow3)
    ox, c = e // 3, e % 3  # the kernel: a thread a pixel, its channels unrolled
    lo3 = torch.from_numpy(sched.cols[:, 0]).long()[ox] + c
    hi3 = torch.from_numpy(sched.cols[:, 1]).long()[ox] + c
    flat = torch.full((n * ph * pw3,), float("nan"))
    written = torch.zeros(n * ph * pw3, dtype=torch.int32)
    for f in range(n):
        for band, band_rows in enumerate(sched.band_src):
            bufs = {s: staged(src[f, r, x_lo:x_lo + x_len],
                              (base + (f * ih + r) * iw * 3 + x_lo) % 16, slot_bytes)
                    for s, r in enumerate(band_rows) if r >= 0}
            offsets = {s: (base + (f * ih + r) * iw * 3 + x_lo) % 16
                       for s, r in enumerate(band_rows) if r >= 0}
            y0 = band * sched.rows_per_block
            for oy in range(y0, min(y0 + sched.rows_per_block, ph)):
                row0 = (f * ph + oy) * pw3
                ob = torch.full((obuf,), float("nan"))
                if oy < out_h:
                    s0, s1 = sched.rows[oy, :2]  # both staged by the band
                    b0, b1, d0, d1 = bufs[s0], bufs[s1], offsets[s0], offsets[s1]
                    v0 = wy[oy, 0] * b0[d0 + lo3] + wy[oy, 1] * b1[d1 + lo3]  # rows first
                    v1 = wy[oy, 0] * b0[d0 + hi3] + wy[oy, 1] * b1[d1 + hi3]
                    x = wx[ox, 0] * v0 + wx[ox, 1] * v1  # then the columns
                    at = row0 % 8
                    ob[at:at + pw3] = 0.0
                    ob[at:at + ow3] = x * scale[c] + shift[c]
                else:
                    ob.zero_()  # a pad row: zeros straight to the output
                k0 = row0 // CHUNK
                g = torch.arange(k0 * CHUNK, -(-(row0 + pw3) // CHUNK) * CHUNK)
                keep = (g >= row0) & (g < row0 + pw3)
                flat[g[keep]] = ob[g[keep] - k0 * CHUNK]
                written[g[keep]] += 1
    assert bool((written == 1).all())
    return flat.reshape(n, ph, pw, 3)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_k1_matches_pallas_and_einsum(case):
    shape, (oh, ow), crop, dtype = CASES[case]
    frames = np.random.RandomState(len(case)).randint(0, 256, shape, dtype=np.uint8)
    before = resize_normalize.launches
    out = resize_normalize(torch.from_numpy(frames), oh, ow, crop=crop, out_dtype=dtype)
    assert resize_normalize.launches == before  # the CPU runs no kernel
    assert out.shape == (shape[0], oh, ow, 3) and out.dtype == dtype
    ref = np.asarray(jax_resize_normalize(frames, oh, ow, crop=crop), np.float32)
    pallas = resize_normalize_pallas(
        jnp.asarray(frames), oh, ow, crop=crop,
        out_dtype=jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32,
        interpret=True,
    )
    got = out.float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, ref, atol=1e-4)
        np.testing.assert_allclose(got, np.asarray(pallas), atol=1e-4)
    else:
        ulp = bf16_ulp(ref)
        ref_bf16 = np.asarray(jnp.asarray(ref).astype(jnp.bfloat16), np.float32)
        assert np.all(np.abs(got - ref_bf16) <= ulp)
        assert np.all(np.abs(got - np.asarray(pallas, np.float32)) <= ulp)


SCHEDULE_CASES = {  # (frames shape, out (h, w), crop, pad_to, frames' address mod 16)
    "plain": ((2, 36, 48, 3), (24, 32), None, (32, 64), 0),
    "crop": ((1, 40, 40, 3), (16, 16), (5, 8, 30, 24), None, 3),
    # taps clamp at both borders (lo == hi, w_hi == 0)
    "upscale-clamp": ((1, 12, 20, 3), (25, 37), None, (32, 64), 7),
    # 480p widescreen cut to 90 rows: rows of 2562 bytes, never 16-aligned, 5.7x fewer columns
    "downscale-odd-width": ((1, 90, 854, 3), (44, 150), None, (64, 160), 5),
}


@pytest.mark.parametrize("case", list(SCHEDULE_CASES))
def test_gather_arithmetic_matches_plain(case):
    """The CUDA kernel's schedule and order of operations (``kernel_rebuild``:
    tables, staged bytes, rows then columns then the affine, 8-element chunks,
    the pad) agrees with the dense plain version and the Pallas kernel in
    interpret mode within the f32 atol, and its pad is exactly 0."""
    shape, (oh, ow), crop, pad_to, base = SCHEDULE_CASES[case]
    frames = torch.from_numpy(np.random.RandomState(9).randint(0, 256, shape, dtype=np.uint8))
    got = kernel_rebuild(frames, oh, ow, crop, pad_to, base)
    torch.testing.assert_close(got, resize_normalize_plain(frames, oh, ow, crop, pad_to=pad_to),
                               atol=1e-4, rtol=0)
    pallas = resize_normalize_pallas(jnp.asarray(frames.numpy()), oh, ow, crop=crop, interpret=True)
    np.testing.assert_allclose(got[:, :oh, :ow].numpy(), np.asarray(pallas), atol=1e-4, rtol=0)
    assert not got[:, oh:].any() and not got[:, :, ow:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_padded_output_matches_the_jax_pipeline_pad(dtype):
    """``pad_to`` gives what the JAX pipeline builds on the host: its
    serving preprocess, as float32, in the corner of ``np.zeros``
    (``tubedetr_tpu/apps/pipeline.py``): f32 within atol 1e-4, bf16 within
    one bf16 ulp, the pad exactly 0. The wrapper on the CPU launches nothing."""
    frames = np.random.RandomState(3).randint(0, 256, (3, 30, 44, 3), dtype=np.uint8)
    oh, ow, ph, pw = 22, 33, 32, 64
    want = np.zeros((3, ph, pw, 3), np.float32)
    want[:, :oh, :ow] = np.asarray(resize_normalize_fused(
        jnp.asarray(frames), oh, ow, out_dtype=jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32,
    ), np.float32)
    before = resize_normalize.launches
    got = resize_normalize(torch.from_numpy(frames), oh, ow, out_dtype=dtype, pad_to=(ph, pw))
    assert resize_normalize.launches == before
    assert got.shape == (3, ph, pw, 3) and got.dtype == dtype
    got = got.float().numpy()
    tol = 1e-4 if dtype == torch.float32 else bf16_ulp(want)
    assert np.all(np.abs(got - want) <= tol)
    assert not got[:, oh:].any() and not got[:, :, ow:].any()
    np.testing.assert_array_equal(
        got, resize_normalize_plain(torch.from_numpy(frames), oh, ow, out_dtype=dtype,
                                    pad_to=(ph, pw)).float().numpy())


@pytest.mark.parametrize(
    "in_size,out_size,start,size",
    [(36, 24, 0.0, -1.0), (10, 25, 0.0, -1.0), (40, 16, 8.0, 24.0), (40, 30, 30.0, 10.0)],
    ids=["down", "up-clamped", "crop", "crop-at-border"],
)
def test_gather_taps_rebuild_interp_matrix(in_size, out_size, start, size):
    """Scattering (lo, hi, w_lo, w_hi) back gives the JAX package's matrix
    exactly; where a border clamps, lo == hi and w_lo carries the merged
    weight."""
    lo, hi, w_lo, w_hi = gather_taps(in_size, out_size, start, size)
    dense = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    np.add.at(dense, (rows, lo), w_lo)
    np.add.at(dense, (rows, hi), w_hi)
    ref = jax_interp_matrix(in_size, out_size, start, size)
    np.testing.assert_array_equal(_interp_matrix(in_size, out_size, start, size), ref)
    np.testing.assert_array_equal(dense, ref)
    assert lo.dtype == hi.dtype == np.int32 and w_lo.dtype == w_hi.dtype == np.float32
    clamped = lo == hi
    if in_size < out_size or start + size >= in_size:
        assert clamped.any()
    assert np.all(w_hi[clamped] == 0) and np.allclose(w_lo[clamped], 1.0)


def test_wrapper_rejects_bad_input():
    with pytest.raises(ValueError, match="uint8"):
        resize_normalize(torch.zeros(1, 8, 8, 3), 4, 4)
    with pytest.raises(ValueError, match="uint8"):
        resize_normalize(torch.zeros(1, 8, 8, dtype=torch.uint8), 4, 4)
    with pytest.raises(ValueError, match="out_dtype"):
        resize_normalize(torch.zeros(1, 8, 8, 3, dtype=torch.uint8), 4, 4, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="pad_to"):
        resize_normalize(torch.zeros(1, 8, 8, 3, dtype=torch.uint8), 4, 4, pad_to=(4, 3))
