"""K1, fused resize (+ crop) + normalize, against the JAX package.

On the CPU the port's wrapper runs K1's plain version (two dense f32
contractions, then the affine). It is held to the Pallas kernel in interpret
mode and to the f32 einsum path of ``ops/preprocess.py`` in the three cases
of ``tests/test_pallas_preprocess.py``: atol 1e-4 for f32 out, one bf16 ulp
of the f32 reference for bf16 out. The gather tables the CUDA kernel reads
are held to ``_interp_matrix``, clamped borders included. The CUDA kernel
itself is held to the plain version in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tubedetr_tpu.ops.pallas_preprocess import resize_normalize_pallas
from tubedetr_tpu.ops.preprocess import _interp_matrix as jax_interp_matrix
from tubedetr_tpu.ops.preprocess import resize_normalize as jax_resize_normalize
from tubedetr_tpu_torch.ops.preprocess import _interp_matrix, gather_taps, norm_affine
from tubedetr_tpu_torch.ops.resize_normalize import resize_normalize, resize_normalize_plain

CASES = {  # (frames shape, out (h, w), crop, out dtype), as in test_pallas_preprocess.py
    "plain": ((2, 36, 48, 3), (24, 32), None, torch.float32),
    "crop": ((1, 40, 40, 3), (16, 16), (5, 8, 30, 24), torch.float32),
    "bf16": ((1, 16, 16, 3), (8, 8), None, torch.bfloat16),
}


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """Spacing of bfloat16 numbers at |x| (8 significant bits)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


def gather_resize(frames: torch.Tensor, out_h, out_w, crop=None) -> torch.Tensor:
    """The CUDA kernel's arithmetic, written with the gather tables in
    PyTorch: per output element, lerp the two source rows at the two source
    columns, then the columns, then the affine, all in f32."""
    ih, iw = frames.shape[1:3]
    top, left, ch, cw = crop if crop is not None else (0, 0, -1, -1)
    rl, rh, rwl, rwh = (torch.from_numpy(a) for a in gather_taps(ih, out_h, float(top), float(ch)))
    cl, chh, cwl, cwh = (torch.from_numpy(a) for a in gather_taps(iw, out_w, float(left), float(cw)))
    x = frames.float()
    r0, r1 = x[:, rl.long()], x[:, rh.long()]  # (N, oh, iw, 3)
    wy0, wy1 = rwl[:, None, None], rwh[:, None, None]
    v0 = wy0 * r0[:, :, cl.long()] + wy1 * r1[:, :, cl.long()]
    v1 = wy0 * r0[:, :, chh.long()] + wy1 * r1[:, :, chh.long()]
    v = cwl[:, None] * v0 + cwh[:, None] * v1
    scale, shift = (torch.from_numpy(a) for a in norm_affine())
    return v * scale + shift


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


@pytest.mark.parametrize("case", ["plain", "crop"])
def test_gather_arithmetic_matches_plain(case):
    """The order of operations the CUDA kernel uses (gather tables, rows
    then columns) agrees with the dense plain version."""
    shape, (oh, ow), crop, _ = CASES[case]
    frames = torch.from_numpy(np.random.RandomState(9).randint(0, 256, shape, dtype=np.uint8))
    torch.testing.assert_close(
        gather_resize(frames, oh, ow, crop),
        resize_normalize_plain(frames, oh, ow, crop), atol=1e-4, rtol=0,
    )


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
