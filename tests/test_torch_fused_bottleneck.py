"""K2 (the fused int8 bottleneck) and the int8 convs of the port against the
JAX package, on the CPU.

The port's ``fused_bottleneck_block`` given CPU tensors runs its plain
version (``torch._int_mm`` products, the 3x3 as an int8 im2col); the JAX side
runs the Pallas kernel in interpret mode and its pure-jnp emulation
``fused_bottleneck_reference``. Both get the same seeded numpy int8 stream,
float kernels and (scale, shift) norms, on the cases of
``tests/test_fused_bottleneck.py``. Tolerance: none, the outputs and the
output scale are equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tubedetr_tpu.ops.fused_bottleneck import (
    fused_bottleneck_block as jax_fused_block,
    fused_bottleneck_reference,
    quantize_weight as jax_quantize_weight,
)
from tubedetr_tpu_torch.ops.fused_bottleneck import (
    MAX_STAGES,
    MAX_TILES,
    SMEM_LIMIT,
    TilePlan,
    _requant,
    band_span,
    column_strips,
    compact_to_grid,
    fold_bottleneck,
    fused_bottleneck_block,
    fused_bottleneck_plain,
    grid_to_compact,
    in_strips,
    n_bands,
    quantize_weight,
    tile_plan,
    tma_box_bytes,
)
from tubedetr_tpu_torch.ops.int8_conv import conv2d_int8, int_mm
from tubedetr_tpu_torch.ops.probe_bottleneck import bottleneck_variant_plain

AM2, AM3, OUT_MAX = 11.0, 9.0, 14.0


def block_inputs(rng, n, h, w, planes):
    """The int8 stream, its scale, HWIO float kernels and (scale, shift)
    norms, as ``tests/test_fused_bottleneck.py`` makes them."""
    c = planes * 4
    xq = rng.randint(-127, 128, (n, h, w, c)).astype(np.int8)
    sx = np.float32(0.023)
    kernels = {
        "conv1": rng.randn(1, 1, c, planes).astype(np.float32) * 0.05,
        "conv2": rng.randn(3, 3, planes, planes).astype(np.float32) * 0.05,
        "conv3": rng.randn(1, 1, planes, c).astype(np.float32) * 0.05,
    }
    norms = {
        name: ((0.5 + rng.rand(feats)).astype(np.float32),
               (0.1 * rng.randn(feats)).astype(np.float32))
        for name, feats in (("bn1", planes), ("bn2", planes), ("bn3", c))
    }
    return xq, sx, kernels, norms


def port_fold(sx, kernels, norms):
    return fold_bottleneck(
        torch.tensor(sx),
        {k: torch.from_numpy(v) for k, v in kernels.items()},
        {k: (torch.from_numpy(a), torch.from_numpy(b)) for k, (a, b) in norms.items()},
        torch.tensor(AM2), torch.tensor(AM3), torch.tensor(OUT_MAX),
    )


@pytest.mark.parametrize("dilation", [1, 2])
@pytest.mark.parametrize("n,h,w", [(2, 6, 6), (3, 5, 7)])
def test_k2_matches_jax_kernel_and_reference(n, h, w, dilation):
    xq, sx, kernels, norms = block_inputs(np.random.RandomState(0), n, h, w, planes=16)
    jargs = (
        jnp.asarray(xq), jnp.float32(sx),
        {k: jnp.asarray(v) for k, v in kernels.items()},
        {k: (jnp.asarray(a), jnp.asarray(b)) for k, (a, b) in norms.items()},
        jnp.float32(AM2), jnp.float32(AM3), jnp.float32(OUT_MAX),
    )
    want_k, so_k = jax_fused_block(*jargs, dilation=dilation, interpret=True)
    want_r, so_r = fused_bottleneck_reference(*jargs, dilation=dilation)

    before = fused_bottleneck_block.launches
    got, so = fused_bottleneck_block(torch.from_numpy(xq), port_fold(sx, kernels, norms), dilation)
    assert fused_bottleneck_block.launches == before  # a CPU tensor runs the plain version
    assert got.dtype == torch.int8 and got.shape == xq.shape
    assert float(so) == float(so_k) == float(so_r)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_r))


def test_k2_at_a_stage_shape_matches_jax_reference():
    """At a resnet26 stage-1 tail shape the port equals the JAX emulation
    exactly. The JAX Pallas kernel, interpreted, is compiled by XLA, which
    contracts its ``acc * a1 + b1`` epilogues into FMAs: there it may differ
    by one step on at most 0.1% of the elements (measured: 10 of 2.6M on a
    trunk's real input)."""
    rng = np.random.RandomState(5)
    xq, sx, kernels, norms = block_inputs(rng, 4, 32, 40, planes=64)
    jargs = (
        jnp.asarray(xq), jnp.float32(sx),
        {k: jnp.asarray(v) for k, v in kernels.items()},
        {k: (jnp.asarray(a), jnp.asarray(b)) for k, (a, b) in norms.items()},
        jnp.float32(AM2), jnp.float32(AM3), jnp.float32(OUT_MAX),
    )
    want_r, _ = fused_bottleneck_reference(*jargs)
    want_k, _ = jax_fused_block(*jargs, interpret=True)
    got, _ = fused_bottleneck_block(torch.from_numpy(xq), port_fold(sx, kernels, norms))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_r))
    diff = np.abs(got.numpy().astype(np.int32) - np.asarray(want_k, np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())


def test_quantize_weight_matches_jax():
    k = np.random.RandomState(1).randn(3, 3, 16, 24).astype(np.float32) * 0.05
    k[..., 3] = 0.0  # an all-zero channel takes the 1e-12 floor
    wq, sw = quantize_weight(torch.from_numpy(k))
    jwq, jsw = jax_quantize_weight(jnp.asarray(k))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
    np.testing.assert_array_equal(sw.numpy(), np.asarray(jsw))


def test_fold_layout_for_the_kernel():
    """The kernel reads each weight output channel first, the reduction
    contiguous: w1 (P, C), w2 (9, P_out, P_in) with tap = ky*3 + kx, w3 (C, P)."""
    xq, sx, kernels, norms = block_inputs(np.random.RandomState(2), 1, 3, 3, planes=8)
    fold = port_fold(sx, kernels, norms)
    w2q, _ = quantize_weight(torch.from_numpy(kernels["conv2"]))
    assert fold.w1.shape == (8, 32) and fold.w2.shape == (9, 8, 8) and fold.w3.shape == (32, 8)
    assert all(getattr(fold, k).is_contiguous() for k in ("w1", "w2", "w3"))
    for ky in range(3):
        for kx in range(3):
            np.testing.assert_array_equal(fold.w2[ky * 3 + kx].numpy(), w2q[ky, kx].T.numpy())
    assert fold.channels == (32, 8)


def test_wrapper_checks_its_input():
    xq, sx, kernels, norms = block_inputs(np.random.RandomState(3), 1, 4, 4, planes=16)
    fold = port_fold(sx, kernels, norms)
    with pytest.raises(ValueError, match="int8"):
        fused_bottleneck_block(torch.from_numpy(xq).float(), fold)
    with pytest.raises(ValueError, match="int8"):
        fused_bottleneck_block(torch.from_numpy(xq[..., :32]), fold)
    with pytest.raises(ValueError, match="device"):
        fused_bottleneck_block(torch.from_numpy(xq).to("meta"), fold)
    out, _ = fused_bottleneck_block(torch.from_numpy(xq), fold)
    np.testing.assert_array_equal(
        out.numpy(), fused_bottleneck_plain(torch.from_numpy(xq), fold).numpy()
    )


STAGE_PLANS = {  # (H, W, C, dilation) -> (ring stages, 64-position tiles a band)
    "layer1": ((88, 152, 256, 1), (3, 16)),
    "layer2": ((44, 76, 512, 1), (3, 11)),
    "layer3": ((22, 38, 1024, 1), (3, 4)),
    "layer4": ((11, 19, 2048, 1), (2, 2)),
    "layer4-dc5": ((22, 38, 2048, 2), (2, 1)),
}


@pytest.mark.parametrize("stage", list(STAGE_PLANS))
def test_band_rows_fit_shared_memory(stage):
    """ResNet-101 at 352x608 (and DC5's layer4): K2's plan fills the 227 KB
    a block may opt into with the ring, the q1 tile (the band and a halo of
    ``d*tw + d`` positions each side) and a 64 x P q2 tile per busy consumer
    warpgroup; no further tile fits at its ring depth, a deeper ring (at most
    3 stages) would leave fewer than 4, and the wrapper refuses a width whose
    q1 tile does not fit."""
    (h, w, c, d), (stages, tiles) = STAGE_PLANS[stage]
    p = c // 4
    plan = tile_plan(w, p, d)
    assert (plan.stages, plan.tiles) == (stages, tiles)
    assert plan.tw == w + 2 * d and plan.band == 64 * tiles
    assert plan.q1_rows % 8 == 0 and plan.q1_rows >= plan.band + 2 * plan.centre
    assert plan.smem_bytes == (1024 + stages * 32768 + 128 + plan.q1_rows * p
                               + 64 * min(tiles, 2) * p)
    assert plan.smem_bytes <= SMEM_LIMIT
    assert tiles == MAX_TILES or TilePlan(w, p, d, stages, tiles + 1).smem_bytes > SMEM_LIMIT
    assert stages == MAX_STAGES or TilePlan(w, p, d, stages + 1, 4).smem_bytes > SMEM_LIMIT
    assert tile_plan(64 * w, p, d) is None
    # the model of a launch's TMA boxes at N=400: the weights more than once,
    # x at least once
    assert tma_box_bytes(plan, 400, h, c) > 400 * h * w * c + 2 * c * p + 9 * p * p


def tiled_block(xq, fold, dilation, plan, variant="full"):
    """The block rebuilt in plain PyTorch from K2's tile plan, band by band:
    conv1 over the compact rows ``band_span`` gives, the fold scattered into
    a zeroed q1 tile at the grid positions, conv2 as nine products of that
    tile shifted by ``tap_offsets`` over whole 64-position tiles (``noshift``:
    nine reads of the centre; ``convonly``: q2 = q1), conv3 and the residual
    at the band's real positions. Every pixel is written once."""
    n, h, w, c = xq.shape
    rows = xq.reshape(-1, c)
    out = torch.zeros_like(rows)
    written = torch.zeros(rows.shape[0], dtype=torch.int32)
    offsets = plan.tap_offsets() if variant == "full" else (0,) * 9
    for b in range(n_bands(plan, n, h)):
        m0, bm, q_lo, p_lo, p_hi = band_span(plan, n, h, b, variant)
        tile = torch.zeros(plan.q1_rows, plan.p, dtype=torch.int8)
        ti = compact_to_grid(torch.arange(p_lo, p_hi), h, plan) - q_lo
        assert p_hi == p_lo or (int(ti.min()) >= 0 and int(ti.max()) < plan.q1_rows)
        tile[ti] = _requant(int_mm(rows[p_lo:p_hi], fold.w1.t()).float() * fold.a1 + fold.b1)
        span = -(-bm // 64) * 64  # whole tiles, as the kernel computes them
        assert span + max(offsets) <= plan.q1_rows
        if variant == "convonly":
            q2 = tile[:span]
        else:
            acc2 = sum(int_mm(tile[o:o + span].contiguous(), fold.w2[t].t())
                       for t, o in enumerate(offsets))
            q2 = _requant(acc2.float() * fold.a2 + fold.b2)
        px = grid_to_compact(torch.arange(m0, m0 + bm), h, plan)
        keep = px >= 0
        px = px[keep]
        y3 = (int_mm(q2[:bm][keep].contiguous(), fold.w3.t()).float() * fold.a3 + fold.b3
              + rows[px].float() * fold.sid)
        out[px] = _requant(y3)
        written[px] += 1
    assert bool((written == 1).all())
    return out.reshape(n, h, w, c)


TILED_CASES = {  # (frames, height, width, dilation, tiles a band)
    # 108 grid positions: bands of 64 and 44, the first ending mid-frame
    "d1": (2, 5, 7, 1, 1),
    # 154 positions in bands of 64, 64, 26: halos of 2*11 + 2 each side
    "d2": (2, 5, 7, 2, 1),
    # 3 frames of 6x6 (8 wide padded): one band of 128 spanning all but 40
    "d1-two-tiles": (3, 6, 6, 1, 2),
    # dilation 2 on 3 frames of 4x9: 3*6*13 = 234 positions, bands of 64, the last 42
    "d2-many-frames": (3, 4, 9, 2, 1),
}


@pytest.mark.parametrize("case", list(TILED_CASES))
def test_tile_plan_reassembles_the_block(case):
    """K2's band, padded-width and tap arithmetic, run in plain PyTorch from
    the plan (``tiled_block``), equals the plain version, the JAX Pallas
    kernel in interpret mode and the JAX reference, bit for bit."""
    n, h, w, d, tiles = TILED_CASES[case]
    xq, sx, kernels, norms = block_inputs(np.random.RandomState(7), n, h, w, planes=16)
    fold = port_fold(sx, kernels, norms)
    plan = TilePlan(w, 16, d, 2, tiles)
    got = tiled_block(torch.from_numpy(xq), fold, d, plan)
    jargs = (
        jnp.asarray(xq), jnp.float32(sx),
        {k: jnp.asarray(v) for k, v in kernels.items()},
        {k: (jnp.asarray(a), jnp.asarray(b)) for k, (a, b) in norms.items()},
        jnp.float32(AM2), jnp.float32(AM3), jnp.float32(OUT_MAX),
    )
    want_k, _ = jax_fused_block(*jargs, dilation=d, interpret=True)
    want_r, _ = fused_bottleneck_reference(*jargs, dilation=d)
    np.testing.assert_array_equal(got.numpy(), fused_bottleneck_plain(torch.from_numpy(xq), fold, d).numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_r))


@pytest.mark.parametrize("variant", ["noshift", "convonly"])
def test_tile_plan_reassembles_the_probe_variants(variant):
    """P4's variants of K2 on the same plan (conv1 over the band alone, the
    tile starting at the centre) equal their plain versions."""
    xq, sx, kernels, norms = block_inputs(np.random.RandomState(8), 3, 5, 7, planes=16)
    fold = port_fold(sx, kernels, norms)
    got = tiled_block(torch.from_numpy(xq), fold, 1, TilePlan(7, 16, 1, 2, 1), variant)
    want = bottleneck_variant_plain(torch.from_numpy(xq), fold, variant)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


STRIP_CASES = {  # (width, P, dilation) -> column strips
    "layer4": ((19, 512, 1), 1),
    "dc5": ((38, 512, 2), 1),
    # DC5's layer4 at res 416 and 480 (long side 693 and 800): its q1 tile
    # does not fit beside the ring above a width of 43
    "dc5-res416": ((44, 512, 2), 2),
    "dc5-res480": ((50, 512, 2), 2),
    "p512-d1-wide": ((120, 512, 1), 2),
    "p64-very-wide": ((4096, 64, 1), 4),
}


@pytest.mark.parametrize("case", list(STRIP_CASES))
def test_column_strips_cover_the_width(case):
    """The strips' kept columns tile the width in order; each strip's input
    is its kept columns and ``d`` more on each side inside the frame; every
    input fits K2's shared memory and one strip fewer would not."""
    (w, p, d), count = STRIP_CASES[case]
    strips = column_strips(w, p, d)
    assert len(strips) == count
    assert [c0 for _, _, c0, _ in strips] == [0] + [c1 for _, _, _, c1 in strips[:-1]]
    assert strips[-1][3] == w
    for s0, s1, c0, c1 in strips:
        assert (s0, s1) == (max(c0 - d, 0), min(c1 + d, w)) and c0 < c1
        assert tile_plan(s1 - s0, p, d) is not None
    if count > 1:
        step = -(-w // (count - 1))  # the widest input of count - 1 strips is at least this wide
        assert tile_plan(min(step + d, w), p, d) is None
    assert column_strips(w, p, 6 if p == 512 else 200) is None  # not one column fits


@pytest.mark.parametrize("case", ["dc5-res416", "dc5-res480", "p512-d1-wide"])
def test_column_strips_reassemble_the_block(case):
    """The block run strip by strip (``in_strips``, at the strips K2 takes
    for that width; the channels cut to P=16) equals the block on the whole
    width, the plain version and the JAX reference, bit for bit."""
    (w, p, d), _ = STRIP_CASES[case]
    xq, sx, kernels, norms = block_inputs(np.random.RandomState(9), 2, 5, w, planes=16)
    fold = port_fold(sx, kernels, norms)
    x = torch.from_numpy(xq)
    calls = []

    def block(xs):
        calls.append(xs.shape[2])
        return fused_bottleneck_plain(xs, fold, d)

    got = in_strips(x, column_strips(w, p, d), block)
    assert len(calls) == 2 and max(calls) < w
    jargs = (
        jnp.asarray(xq), jnp.float32(sx),
        {k: jnp.asarray(v) for k, v in kernels.items()},
        {k: (jnp.asarray(a), jnp.asarray(b)) for k, (a, b) in norms.items()},
        jnp.float32(AM2), jnp.float32(AM3), jnp.float32(OUT_MAX),
    )
    want_r, _ = fused_bottleneck_reference(*jargs, dilation=d)
    np.testing.assert_array_equal(got.numpy(), fused_bottleneck_plain(x, fold, d).numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_r))


CONV_CASES = {  # (k, stride, dilation, in channels, out channels)
    "1x1": (1, 1, 1, 32, 16),
    "1x1-s2": (1, 2, 1, 32, 64),
    "3x3": (3, 1, 1, 16, 16),
    "3x3-s2": (3, 2, 1, 16, 24),
    "3x3-d2": (3, 1, 2, 16, 16),
}


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_int8_conv_matches_xla(case):
    """``conv2d_int8`` against the JAX package's s8 x s8 -> s32
    ``conv_general_dilated`` (resnet.py ``BottleneckConv``): equal."""
    k, stride, dilation, cin, cout = CONV_CASES[case]
    rng = np.random.RandomState(4)
    xq = rng.randint(-127, 128, (2, 7, 9, cin)).astype(np.int8)
    wq = rng.randint(-127, 128, (k, k, cin, cout)).astype(np.int8)
    pad = dilation * (k // 2)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(wq), window_strides=(stride, stride),
        padding=[(pad, pad)] * 2, rhs_dilation=(dilation, dilation),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32,
    )
    w_ok = torch.from_numpy(wq).permute(3, 0, 1, 2).reshape(cout, -1).contiguous()
    got = conv2d_int8(torch.from_numpy(xq), w_ok, k, stride, dilation)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
