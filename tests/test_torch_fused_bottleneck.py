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
    BAND_ROWS,
    SMEM_LIMIT,
    fold_bottleneck,
    fused_bottleneck_block,
    fused_bottleneck_plain,
    quantize_weight,
    smem_bytes,
)
from tubedetr_tpu_torch.ops.int8_conv import conv2d_int8

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


@pytest.mark.parametrize(
    "h,w,c,d",
    [(88, 152, 256, 1), (44, 76, 512, 1), (22, 38, 1024, 1), (11, 19, 2048, 1), (22, 38, 2048, 2)],
    ids=["layer1", "layer2", "layer3", "layer4", "layer4-dc5"],
)
def test_band_rows_fit_shared_memory(h, w, c, d):
    """ResNet-101 at 352x608 (and DC5's layer4): two output rows a block,
    within the 227 KB a block may opt into; the wrapper refuses a width
    whose band does not fit."""
    assert BAND_ROWS == 2
    assert smem_bytes(w, c // 4, d) <= SMEM_LIMIT
    assert smem_bytes(w, c // 4, d) == ((2 + 2 * d) * (w + 2 * d) + 2 * w) * (c // 4 + 16)
    assert smem_bytes(8 * w, c // 4, d) > SMEM_LIMIT


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
