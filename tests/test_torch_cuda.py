"""Tests of the port that need an NVIDIA GPU, marked ``cuda``.

They hold the CUDA kernels (K1, resize+normalize; K2, the fused int8
bottleneck; the probes P1-P5) to their plain PyTorch versions on the card,
and the pipeline on the card (float, and int8_static + K2) to the pipeline
on the CPU. This file imports
nothing of JAX, so it also runs on a machine with only PyTorch:

    python -m pytest tests/test_torch_cuda.py -q

Without a card every test skips (the decision is made inside each test, so
every pytest worker collects the same tests).
"""

import numpy as np
import pytest
import torch

from tubedetr_tpu_torch.ops.fused_bottleneck import (
    fold_bottleneck,
    fused_bottleneck_block,
    fused_bottleneck_plain,
)
from tubedetr_tpu_torch.ops import _cuda_build
from tubedetr_tpu_torch.ops.probe_bottleneck import (
    bottleneck_variant,
    flat_bottleneck,
    flat_smem_bytes,
)
from tubedetr_tpu_torch.ops.probe_mm import bf16_mm, int8_mm, int8_mm_frames
from tubedetr_tpu_torch.ops.resize_normalize import resize_normalize, resize_normalize_plain
from tubedetr_tpu_torch.probes import fused_variants as fv
from tubedetr_tpu_torch.probes import int8_matmul as im

pytestmark = pytest.mark.cuda

K1_CASES = {  # (frames shape, out (h, w), crop, out dtype)
    "plain": ((2, 36, 48, 3), (24, 32), None, torch.float32),
    "crop": ((1, 40, 40, 3), (16, 16), (5, 8, 30, 24), torch.float32),
    "bf16": ((1, 16, 16, 3), (8, 8), None, torch.bfloat16),
    "serving-bf16": ((8, 360, 640, 3), (330, 586), None, torch.bfloat16),
}


def require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126))) - 7)


@pytest.mark.parametrize("case", list(K1_CASES))
def test_k1_kernel_matches_plain(case):
    """f32 out within atol 1e-4; bf16 out within one bf16 ulp of the f32
    plain value plus that atol (near 0 the affine's cancellation leaves the
    two f32 computations ~1e-6 apart, more than a bf16 ulp there); each call
    launches the kernel once."""
    require_cuda()
    shape, (oh, ow), crop, dtype = K1_CASES[case]
    gen = torch.Generator().manual_seed(4)
    frames = torch.randint(0, 256, shape, dtype=torch.uint8, generator=gen).cuda()
    before = resize_normalize.launches
    out = resize_normalize(frames, oh, ow, crop=crop, out_dtype=dtype)
    ref = resize_normalize_plain(frames, oh, ow, crop, torch.float32)
    torch.cuda.synchronize()
    assert resize_normalize.launches == before + 1
    assert out.shape == (shape[0], oh, ow, 3) and out.dtype == dtype
    err = (out.float() - ref).abs()
    tol = 1e-4 if dtype == torch.float32 else bf16_ulp(ref) + 1e-4
    assert bool((err <= tol).all()), err.max().item()


def test_k1_rejects_non_contiguous():
    require_cuda()
    frames = torch.zeros(2, 8, 8, 3, dtype=torch.uint8, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        resize_normalize(frames[:, ::2], 4, 4)


def test_pipeline_on_the_card_matches_the_cpu(tmp_path):
    """One small request through the pipeline on the card (K1, cuDNN,
    cuBLAS, TF32 off) and on the CPU (plain versions), same seed weights.
    Tolerance 1e-3 on the normalized boxes: summation orders differ through
    a whole model."""
    require_cuda()
    from tubedetr_tpu_torch.apps.pipeline import GroundingPipeline
    from tubedetr_tpu_torch.config import TubeDETRConfig

    cfg = TubeDETRConfig(
        backbone="resnet14", hidden_dim=32, nheads=4, enc_layers=1, dec_layers=2,
        dim_feedforward=64, video_max_len=8, video_max_len_train=8, stride=2,
        resolution=128, max_text_len=8, text_vocab_size=128, text_hidden_size=32,
        text_layers=1, text_heads=4, text_ffn=64, text_max_positions=40,
        guided_attn=False, aux_loss=False, dropout=0.0,
    )
    path = str(tmp_path / "clip.npy")
    np.save(path, np.random.RandomState(1).randint(0, 256, (7, 96, 160, 3), dtype=np.uint8))
    before = resize_normalize.launches
    out = {dev: GroundingPipeline(cfg, device=dev).ground(path, "a red square", render=False)
           for dev in ("cuda", "cpu")}
    assert resize_normalize.launches == before + 1
    size = np.array([160, 96, 160, 96], np.float64)
    np.testing.assert_allclose(np.asarray(out["cuda"]["boxes"]) / size,
                               np.asarray(out["cpu"]["boxes"]) / size, atol=1e-3)


K2_CASES = {  # (frames, height, width, planes, dilation)
    "d1": (3, 5, 7, 64, 1),
    "d2": (3, 5, 7, 64, 2),
    "tall-p128": (2, 9, 13, 128, 1),
}


def k2_inputs(n, h, w, planes, seed=0):
    rng = np.random.RandomState(seed)
    c = planes * 4
    xq = torch.from_numpy(rng.randint(-127, 128, (n, h, w, c)).astype(np.int8))
    kernels = {
        "conv1": torch.from_numpy(rng.randn(1, 1, c, planes).astype(np.float32) * 0.05),
        "conv2": torch.from_numpy(rng.randn(3, 3, planes, planes).astype(np.float32) * 0.05),
        "conv3": torch.from_numpy(rng.randn(1, 1, planes, c).astype(np.float32) * 0.05),
    }
    norms = {
        name: (torch.from_numpy((0.5 + rng.rand(f)).astype(np.float32)),
               torch.from_numpy((0.1 * rng.randn(f)).astype(np.float32)))
        for name, f in (("bn1", planes), ("bn2", planes), ("bn3", c))
    }
    fold = fold_bottleneck(torch.tensor(0.023), kernels, norms, torch.tensor(11.0),
                           torch.tensor(9.0), torch.tensor(14.0))
    return xq, fold


def fold_to(fold, device):
    return type(fold)(**{k: v.to(device) for k, v in vars(fold).items()})


@pytest.mark.parametrize("case", list(K2_CASES))
def test_k2_kernel_matches_plain(case):
    """K2 (the ``Full`` instantiation of the kernel template) on the card
    equals its plain version bit for bit, on the card (cuBLASLt products)
    and on the CPU, given the same fold; one launch. The probe's ``full``
    runs the same kernel and gives the same output."""
    require_cuda()
    n, h, w, planes, d = K2_CASES[case]
    xq, fold = k2_inputs(n, h, w, planes)
    cfold = fold_to(fold, "cuda")
    before = fused_bottleneck_block.launches
    out, so = fused_bottleneck_block(xq.cuda(), cfold, d)
    torch.cuda.synchronize()
    assert fused_bottleneck_block.launches == before + 1
    assert out.dtype == torch.int8 and out.shape == xq.shape and float(so) == float(fold.so)
    assert torch.equal(out.cpu(), fused_bottleneck_plain(xq.cuda(), cfold, d).cpu())
    assert torch.equal(out.cpu(), fused_bottleneck_plain(xq, fold, d))
    if d == 1:
        assert torch.equal(out, bottleneck_variant(xq.cuda(), cfold, "full"))


def test_k2_rejects_what_it_cannot_take():
    require_cuda()
    xq, fold = k2_inputs(1, 4, 4, 16)
    with pytest.raises(ValueError, match="multiples of 64"):
        fused_bottleneck_block(xq.cuda(), fold_to(fold, "cuda"))
    xq, fold = k2_inputs(1, 4, 8, 64)
    with pytest.raises(ValueError, match="contiguous"):
        fused_bottleneck_block(xq.cuda()[:, :, ::2], fold_to(fold, "cuda"))
    xq, fold = k2_inputs(1, 2, 4096, 64)
    with pytest.raises(ValueError, match="shared memory"):
        fused_bottleneck_block(xq.cuda(), fold_to(fold, "cuda"))


def test_int8_pipeline_on_the_card_matches_the_cpu(tmp_path):
    """A small int8_static + fused request (resnet26: a K2 tail per stage):
    calibrated on the CPU, the same scales copied to the card, the same
    frames on both. Card convs sum in another order than the CPU's, so an
    int8 rounding on a boundary can flip; the tolerance on the normalized
    boxes and the sted logits is that of ``chip_smoke.py``'s int8 agreement
    phase."""
    require_cuda()
    import chip_smoke
    from tubedetr_tpu_torch.apps.pipeline import GroundingPipeline
    from tubedetr_tpu_torch.models.quantize import model_qscales

    cfg = chip_smoke.small_cfg().replace(
        backbone="resnet26", backbone_quant="int8_static", fused_bottleneck=True
    )
    path = str(tmp_path / "clip.npy")
    np.save(path, np.random.RandomState(1).randint(0, 256, (7, 96, 160, 3), dtype=np.uint8))
    cpu = GroundingPipeline(cfg, device="cpu")
    sample, _ = cpu.prepare(path, "a red square", -1, -1, "v")
    ref, _ = cpu.forward([sample])  # calibrates on the CPU
    card = GroundingPipeline(cfg, device="cuda")
    card.set_qscales(model_qscales(cpu.model))
    sample.frames = sample.frames.cuda()
    before = fused_bottleneck_block.launches
    out, _ = card.forward([sample])
    assert fused_bottleneck_block.launches == before + 4
    for k in ("pred_boxes", "pred_sted"):
        np.testing.assert_allclose(out[k], ref[k], atol=chip_smoke.SMALL_INT8_ATOL[k], err_msg=k)


PROBE_MM_CASES = {  # (frames, rows a frame, K, N)
    "small": (2, 64, 64, 128),  # K and N below one 128-byte slice and one 256-column tile
    "ragged": (3, 37, 96, 192),  # frames of 37 rows: one partial tile each
    # the probe's widths: P1's 1452 rows end in a 44-row tile, P3's frames in 100-row tiles
    "probe-widths": (3, 484, 1024, 256),
    # 304 (P1) and 320 (P3) tiles, more than an H100's 132 SMs: the persistent
    # loop wraps, the 4-stage ring's phases cross tiles (3 slices of K a tile in
    # s8, 5 in bf16, the last one partial), and N spans two column tiles
    "wrap": (40, 484, 320, 512),
}


@pytest.mark.parametrize("case", list(PROBE_MM_CASES))
def test_probe_gemms_match_plain(case):
    """P1, P2, P3 equal their plain versions exactly, on the card and on the
    CPU, where tiles are partial in rows, in columns and in K."""
    require_cuda()
    frames, hw, k, n = PROBE_MM_CASES[case]
    x, wt = im.make_inputs(np.random.RandomState(0), frames, hw, k, n, device="cpu")
    prods = {dev: {p.probe: p for p in im.products(x.to(dev), wt.to(dev), hw, 2)}
             for dev in ("cpu", "cuda")}
    counters = {"P1": int8_mm, "P2": bf16_mm, "P3": int8_mm_frames}
    for key, wrapper in counters.items():
        before = wrapper.launches
        out = prods["cuda"][key].call()
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1, key
        assert torch.equal(out, prods["cuda"][key].plain()), key
        assert torch.equal(out.cpu(), prods["cpu"][key].call()), key


PROBE_BLOCK_CASES = {  # (frames, height, width, C, P)
    "small": (3, 5, 7, 256, 64),
    "tall-odd": (2, 9, 13, 512, 128),
}


@pytest.mark.parametrize("variant", ["full", "noshift", "convonly"])
@pytest.mark.parametrize("case", list(PROBE_BLOCK_CASES))
def test_probe_bottleneck_variants_match_plain(case, variant):
    """P4's variants of K2 equal their plain versions bit for bit."""
    require_cuda()
    n, h, w, c, p = PROBE_BLOCK_CASES[case]
    x, fold = fv.make_inputs(False, n, h, w, c, p, device="cuda")
    before = bottleneck_variant.launches
    out = fv.variant_call(variant, x, fold, h, w)()
    torch.cuda.synchronize()
    assert bottleneck_variant.launches == before + 1
    assert torch.equal(out, fv.plain_call(variant, x, fold, h, w)())


@pytest.mark.parametrize("variant", ["hwpad", "im2col"])
@pytest.mark.parametrize("case", list(PROBE_BLOCK_CASES))
def test_flat_bottleneck_matches_plain(case, variant):
    """P5 equals its plain version bit for bit, pad rows 0, at frames of
    h*w + w + 1 rows (not a multiple of 16) whose blocks cross frames and end
    ragged."""
    require_cuda()
    n, h, w, c, p = PROBE_BLOCK_CASES[case]
    hwp = h * w + w + 1
    x, fold = fv.make_inputs(True, n, h, w, c, p, hwp, device="cuda")
    before = flat_bottleneck.launches
    out = fv.variant_call(variant, x, fold, h, w)()
    torch.cuda.synchronize()
    assert flat_bottleneck.launches == before + 1
    assert torch.equal(out, fv.plain_call(variant, x, fold, h, w)())
    assert not out[:, h * w:].any()


@pytest.mark.parametrize("variant", ["hwpad", "im2col"])
def test_flat_smem_bytes_is_the_kernels_count(variant):
    """The wrapper's shared-memory count for a P5 block, which it checks
    before a launch, is the one the built kernel requests."""
    require_cuda()
    import ctypes

    fn = _cuda_build.load("probe_flat_bottleneck").flat_bottleneck_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_longlong
    for w, p in ((fv.W, fv.P), (13, 128), (38, 64)):
        assert flat_smem_bytes(variant, w, p) == fn(int(variant == "im2col"), w, p), (w, p)


def test_probe_gemms_reject_unaligned_bases():
    """TMA reads from 16-byte aligned bases: the wrappers raise for a
    contiguous view that starts one byte in, and the C entry refuses it."""
    require_cuda()
    from tubedetr_tpu_torch.ops import probe_mm

    x, wt = im.make_inputs(np.random.RandomState(0), 1, 32, 64, 64, device="cuda")
    buf = torch.zeros(x.numel() + 1, dtype=torch.int8, device="cuda")
    shifted = buf[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.is_contiguous() and shifted.storage_offset() == 1
    with pytest.raises(ValueError, match="16-byte aligned"):
        int8_mm(shifted, wt)
    with pytest.raises(ValueError, match="16-byte aligned"):
        int8_mm_frames(shifted.view(1, 32, 64), wt)
    out = torch.empty(32, 64, dtype=torch.int32, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA error"):
        probe_mm._launch("probe_mm_s8", shifted, wt, out, 32)
    assert torch.equal(int8_mm(x, wt), int8_mm(shifted.clone(), wt))


def test_probes_reject_what_they_cannot_take():
    require_cuda()
    x, wt = im.make_inputs(np.random.RandomState(0), 1, 32, 64, 96, device="cuda")
    with pytest.raises(ValueError, match="multiple of 64"):
        int8_mm(x, wt)
    x, wt = im.make_inputs(np.random.RandomState(0), 1, 32, 40, 64, device="cuda")
    with pytest.raises(ValueError, match="multiple of 16"):
        bf16_mm(x.bfloat16(), wt.bfloat16())
    x, fold = fv.make_inputs(False, 1, 4, 4, 128, 32, device="cuda")
    with pytest.raises(ValueError, match="multiples of 64"):
        bottleneck_variant(x.view(1, 4, 4, 128), fold, "noshift")
    x, fold = fv.make_inputs(True, 1, 2, 512, 1024, 256, hwp=2 * 512 + 513, device="cuda")
    with pytest.raises(ValueError, match="shared memory"):
        flat_bottleneck(x, fold, "im2col", 2, 512)
