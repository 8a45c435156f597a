"""Tests of the port that need an NVIDIA GPU, marked ``cuda``.

They hold the CUDA kernels (K1, resize+normalize; K2, the fused int8
bottleneck, also at the train CLI's layer maps; G1, the grouped int8 conv of
the timm trunks; the probes P1-P5) to their
plain PyTorch versions on the card, and the pipeline on the card (float,
and int8_static + K2) to the pipeline on the CPU; the HTTP server on the
card coalesces two concurrent requests into one forward; the data
pipeline's ``DevicePrefetcher`` gives the batches a synchronous copy gives;
the profiler's trace holds the card's kernels.
This file imports
nothing of JAX, so it also runs on a machine with only PyTorch:

    python -m pytest tests/test_torch_cuda.py -q

Without a card every test skips (the decision is made inside each test, so
every pytest worker collects the same tests).
"""

import numpy as np
import pytest
import torch

from tubedetr_tpu_torch.ops.fused_bottleneck import (
    column_strips,
    fold_bottleneck,
    fused_bottleneck_block,
    fused_bottleneck_plain,
    kernel_plan,
    n_bands,
    tile_plan,
)
from tubedetr_tpu_torch.ops.int8_conv import (
    g1_path,
    grouped_conv2d_int8,
    grouped_conv2d_int8_plain,
)
from tubedetr_tpu_torch.ops.probe_bottleneck import bottleneck_variant, flat_bottleneck
from tubedetr_tpu_torch.ops.probe_mm import bf16_mm, int8_mm, int8_mm_frames
from tubedetr_tpu_torch.ops.resize_normalize import resize_normalize, resize_normalize_plain
from tubedetr_tpu_torch.probes import fused_variants as fv
from tubedetr_tpu_torch.probes import int8_matmul as im

pytestmark = pytest.mark.cuda

K1_CASES = {  # (frames shape, out (h, w), crop, out dtype, pad_to, leading frames sliced off)
    "plain": ((2, 36, 48, 3), (24, 32), None, torch.float32, None, 0),
    "crop": ((1, 40, 40, 3), (16, 16), (5, 8, 30, 24), torch.float32, None, 0),
    "bf16": ((1, 16, 16, 3), (8, 8), None, torch.bfloat16, None, 0),
    "serving-bf16": ((8, 360, 640, 3), (330, 586), None, torch.bfloat16, None, 0),
    # the serving path's padded frame buffer, both dtypes
    "pad-bf16": ((4, 360, 640, 3), (330, 586), None, torch.bfloat16, (352, 608), 0),
    "pad-f32": ((4, 360, 640, 3), (330, 586), None, torch.float32, (352, 608), 0),
    # 480p widescreen: source rows of 2562 bytes, 2 apart mod 16 from row to row
    "odd-854": ((2, 480, 854, 3), (330, 587), None, torch.bfloat16, (352, 608), 0),
    # rows of 1281 bytes, frames of an odd byte count, the batch sliced one
    # frame in: the source base is not 16-byte aligned
    "odd-427-misaligned": ((3, 241, 427, 3), (200, 355), None, torch.float32, (224, 384), 1),
    # 1080p to 352: output rows 3 source rows apart, a staged row of 5760 bytes
    "1080p-down": ((2, 1080, 1920, 3), (352, 626), None, torch.bfloat16, (352, 640), 0),
    # 240p up to 352: taps clamp at both borders
    "240p-up": ((2, 240, 426, 3), (352, 625), None, torch.float32, (352, 640), 0),
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
    two f32 computations ~1e-6 apart, more than a bf16 ulp there); the pad
    exactly 0 (the output is ``torch.empty`` over memory filled with
    garbage first); each call launches the kernel once."""
    require_cuda()
    shape, (oh, ow), crop, dtype, pad_to, lead = K1_CASES[case]
    gen = torch.Generator().manual_seed(4)
    batch = torch.randint(0, 256, (shape[0] + lead, *shape[1:]), dtype=torch.uint8, generator=gen)
    frames = batch.cuda()[lead:]
    assert frames.is_contiguous() and (frames.data_ptr() % 16 != 0) == (lead > 0)
    ph, pw = pad_to or (oh, ow)
    torch.full((shape[0], ph, pw, 3), float("nan"), dtype=dtype, device="cuda")  # freed: garbage
    before = resize_normalize.launches
    out = resize_normalize(frames, oh, ow, crop=crop, out_dtype=dtype, pad_to=pad_to)
    ref = resize_normalize_plain(frames, oh, ow, crop, torch.float32, pad_to=pad_to)
    torch.cuda.synchronize()
    assert resize_normalize.launches == before + 1
    assert out.shape == (shape[0], ph, pw, 3) and out.dtype == dtype
    err = (out.float() - ref).abs()
    tol = 1e-4 if dtype == torch.float32 else bf16_ulp(ref) + 1e-4
    assert bool((err <= tol).all()), err.max().item()
    assert not out[:, oh:].any() and not out[:, :, ow:].any()


def test_k1_smem_bytes_is_the_kernels_count():
    """The wrapper's shared-memory count for a K1 block, which it checks
    before a launch, is the one the built kernel requests."""
    require_cuda()
    import ctypes

    from tubedetr_tpu_torch.ops import _cuda_build
    from tubedetr_tpu_torch.ops.resize_normalize import k1_schedule

    fn = _cuda_build.load("resize_normalize").resize_normalize_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 5, ctypes.c_longlong
    for ih, iw, oh, ow, pad_to in ((360, 640, 330, 586, (352, 608)), (480, 854, 330, 587, None),
                                   (1080, 1920, 352, 626, (352, 640)), (241, 427, 200, 355, None)):
        sched = k1_schedule(ih, iw, oh, ow, None, pad_to)
        assert sched.smem_bytes == fn(ow, (pad_to or (oh, ow))[1], sched.x_len, sched.slots,
                                      sched.rows_per_block)


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


def test_server_on_the_card_coalesces_two_requests(tmp_path):
    """The port's Server on the card (its default device): two concurrent
    /stvg requests run as one forward, K1 launches once a request, and each
    tube is the one the pipeline gives the request alone."""
    require_cuda()
    import json
    import threading
    import time
    import urllib.parse
    import urllib.request
    from http.server import ThreadingHTTPServer

    from tubedetr_tpu_torch.apps.serve import Server, make_handler
    from tubedetr_tpu_torch.config import TubeDETRConfig

    cfg = TubeDETRConfig(
        backbone="resnet14", hidden_dim=32, nheads=4, enc_layers=1, dec_layers=2,
        dim_feedforward=64, video_max_len=8, video_max_len_train=8, stride=2,
        resolution=128, max_text_len=8, text_vocab_size=128, text_hidden_size=32,
        text_layers=1, text_heads=4, text_ffn=64, text_max_positions=40,
        guided_attn=False, aux_loss=False, dropout=0.0, serve_max_batch=2,
        output_dir=str(tmp_path / "out"),
    )
    for i in range(2):
        np.save(tmp_path / f"clip{i}.npy",
                np.random.RandomState(i).randint(0, 256, (7 - i, 96, 160, 3), dtype=np.uint8))
    server = Server(cfg, video_root=str(tmp_path))
    assert server.pipeline.device.type == "cuda"
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    out = {}

    def fire(i):
        q = urllib.parse.urlencode({"video": f"clip{i}.npy", "question": "a red square",
                                    "format": "json"})
        out[i] = json.loads(urllib.request.urlopen(f"{url}/stvg?{q}", timeout=300).read())

    before = resize_normalize.launches
    with server.lock:  # the dispatcher waits until both requests are queued
        threads = [threading.Thread(target=fire, args=(i,)) for i in range(2)]
        for th in threads:
            th.start()
        deadline = time.time() + 60
        while len(server._pending) < 2 and time.time() < deadline:
            time.sleep(0.01)
        assert len(server._pending) == 2, "requests never enqueued"
    for th in threads:
        th.join(timeout=300)
    httpd.shutdown()
    assert server.pipeline.forwards == 1
    assert resize_normalize.launches == before + 2
    size = np.array([160, 96, 160, 96], np.float64)
    for i in range(2):
        alone = server.pipeline.ground(str(tmp_path / f"clip{i}.npy"), "a red square",
                                       render=False)
        assert out[i]["sted"] == alone["sted"]
        np.testing.assert_allclose(np.asarray(out[i]["boxes"]) / size,
                                   np.asarray(alone["boxes"]) / size, atol=1e-4)


K2_CASES = {  # (frames, height, width, planes, dilation)
    "d1": (3, 5, 7, 64, 1),
    "d2": (3, 5, 7, 64, 2),
    "tall-p128": (2, 9, 13, 128, 1),
    # layer3's width on 40 frames: 144 bands of 256 positions, more than an
    # H100's 132 SMs, so the persistent blocks take a second band; 22 rows are
    # 3.4 bands a frame, so bands cross frames and rows
    "many-bands": (40, 22, 38, 256, 1),
    # layer4's width: 2 * 14 * 21 = 588 positions in bands of 128, the last
    # one 76 positions (not a multiple of 64)
    "ragged-p512": (2, 13, 19, 512, 1),
    # P=64 with C=256 at layer1's width: bands of 1024, the last 932 positions
    "p64-wide": (2, 12, 152, 64, 1),
    # DC5's layer4 (P=512, C=2048, d=2) on a few frames: bands of 64
    "dc5": (2, 22, 38, 512, 2),
    # DC5's layer4 at res 416 and 480: widths whose q1 tile does not fit, run
    # in two column strips
    "dc5-w44": (2, 9, 44, 512, 2),
    "dc5-w50": (2, 7, 50, 512, 2),
    # P=64 on a very wide frame: four strips of about 1024 columns
    "p64-strips": (1, 3, 4096, 64, 1),
}
K2_STRIPS = {"dc5-w44": 2, "dc5-w50": 2, "p64-strips": 4}  # column strips, where not 1


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
    and on the CPU, given the same fold; one launch a column strip (one,
    but for a width whose q1 tile does not fit). The probe's ``full`` runs
    the same kernel and gives the same output."""
    require_cuda()
    n, h, w, planes, d = K2_CASES[case]
    xq, fold = k2_inputs(n, h, w, planes)
    cfold = fold_to(fold, "cuda")
    before = fused_bottleneck_block.launches
    out, so = fused_bottleneck_block(xq.cuda(), cfold, d)
    torch.cuda.synchronize()
    strips = len(column_strips(w, planes, d))
    assert strips == K2_STRIPS.get(case, 1)
    assert fused_bottleneck_block.launches == before + strips
    assert out.dtype == torch.int8 and out.shape == xq.shape and float(so) == float(fold.so)
    assert torch.equal(out.cpu(), fused_bottleneck_plain(xq.cuda(), cfold, d).cpu())
    assert torch.equal(out.cpu(), fused_bottleneck_plain(xq, fold, d))
    if d == 1:
        assert torch.equal(out, bottleneck_variant(xq.cuda(), cfold, "full"))


def test_k2_many_bands_case_outnumbers_the_sms():
    """The ``many-bands`` case gives the persistent kernel more bands than
    the card has SMs."""
    require_cuda()
    n, h, w, planes, d = K2_CASES["many-bands"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert n_bands(tile_plan(w, planes, d), n, h) > sms


@pytest.mark.parametrize("p", [64, 128, 256, 512])
def test_k2_plan_is_the_kernels_plan(p):
    """The wrapper's tile plan (band, ring, shared memory), which it checks
    before a launch, is the one the built kernel makes, at the stage widths
    and small ones, and both refuse the same too-wide band."""
    require_cuda()
    for w, d in ((152, 1), (76, 1), (38, 1), (19, 1), (38, 2), (5, 1), (13, 2), (4096, 1),
                 (22, 1), (7, 1)):
        for im2col in (False, True):  # im2col: P5's variant with its patch slots
            plan = tile_plan(w, p, d, im2col)
            mine = None if plan is None else (plan.tw, plan.stages, plan.tiles, plan.q1_rows,
                                              plan.smem_bytes)
            assert kernel_plan(w, p, d, im2col) == mine, (w, p, d, im2col)
    assert kernel_plan(38, 192, 1) is None and tile_plan(38, 192, 1) is None


def test_k2_rejects_what_it_cannot_take():
    require_cuda()
    xq, fold = k2_inputs(1, 4, 4, 16)
    with pytest.raises(ValueError, match="multiples of 64"):
        fused_bottleneck_block(xq.cuda(), fold_to(fold, "cuda"))
    xq, fold = k2_inputs(1, 4, 4, 192)  # a multiple of 64 the kernel is not built for
    with pytest.raises(ValueError, match="P in"):
        fused_bottleneck_block(xq.cuda(), fold_to(fold, "cuda"))
    xq, fold = k2_inputs(1, 4, 8, 64)
    buf = torch.zeros(xq.numel() + 1, dtype=torch.int8, device="cuda")
    shifted = buf[1:].view(xq.shape)
    shifted.copy_(xq)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused_bottleneck_block(shifted, fold_to(fold, "cuda"))
    xq, fold = k2_inputs(1, 4, 8, 64)
    with pytest.raises(ValueError, match="contiguous"):
        fused_bottleneck_block(xq.cuda()[:, :, ::2], fold_to(fold, "cuda"))
    xq, fold = k2_inputs(1, 2, 40, 512)  # at dilation 6 not one column's q1 tile fits
    with pytest.raises(ValueError, match="shared memory"):
        fused_bottleneck_block(xq.cuda(), fold_to(fold, "cuda"), 6)


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
    # P=512: im2col's conv2 runs in passes of 128 channels there
    "p512": (2, 6, 9, 2048, 512),
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
    """P5, K2's kernel in its flat layout, equals its plain version bit for
    bit, pad rows 0 (the output is ``torch.empty`` over memory filled with
    garbage first), at frames of h*w + w + 1 rows (not a multiple of 16)
    whose bands and TMA boxes cross frames and end ragged."""
    require_cuda()
    n, h, w, c, p = PROBE_BLOCK_CASES[case]
    hwp = h * w + w + 1
    x, fold = fv.make_inputs(True, n, h, w, c, p, hwp, device="cuda")
    torch.full_like(x, 85)  # freed: garbage where the output will be
    before = flat_bottleneck.launches
    out = fv.variant_call(variant, x, fold, h, w)()
    torch.cuda.synchronize()
    assert flat_bottleneck.launches == before + 1
    assert torch.equal(out, fv.plain_call(variant, x, fold, h, w)())
    assert not out[:, h * w:].any()


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


def test_train_step_on_the_card_matches_the_cpu():
    """One dropout-free train step of a tiny model (B=2, ragged durations 8
    and 7, fast branch, ``grad_accum=2``, clip, EMA) on the card and on the
    CPU from the same weights and batch. SGD, so the update is linear in the
    gradient: the loss terms and the pre-clip grad norm within rtol 1e-4
    (float32 sums in another order, TF32 off), the post-step parameters and
    EMA within atol 1e-6."""
    require_cuda()
    from tubedetr_tpu_torch.config import TubeDETRConfig
    from tubedetr_tpu_torch.data.collate import collate_pairs
    from tubedetr_tpu_torch.data.synthetic import make_synthetic_sample
    from tubedetr_tpu_torch.models.tubedetr import build_model
    from tubedetr_tpu_torch.parallel.train_step import create_train_state, make_train_step

    cfg = TubeDETRConfig(
        backbone="resnet14", hidden_dim=32, nheads=4, enc_layers=1, dec_layers=2,
        dim_feedforward=64, video_max_len=8, video_max_len_train=8, stride=2,
        max_text_len=8, text_vocab_size=128, text_hidden_size=32, text_layers=1,
        text_heads=4, text_ffn=64, text_max_positions=40, batch_size=2, grad_accum=2,
        optimizer="sgd", ema=True, ema_decay=0.9,
    )
    lrs = {"lr": 1e-2, "lr_backbone": 1e-3, "lr_text_encoder": 1e-2}
    torch.manual_seed(0)
    weights = build_model(cfg, device="cpu").state_dict()
    samples = [make_synthetic_sample(i, t=8 - i, vocab=128) for i in range(2)]
    ((batch, _),) = collate_pairs(samples, 2, 8, cfg.stride, cfg.max_text_len)
    out = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, device=dev)
        model.load_state_dict(weights)
        state = create_train_state(cfg, model)
        state, metrics = make_train_step(cfg, deterministic=True)(state, batch, lrs, 0)
        out[dev] = ({k: float(v) for k, v in metrics.items()},
                    {n: p.detach().cpu() for n, p in model.named_parameters()},
                    {n: e.cpu() for n, e in state.ema_params.items()})
    (m_card, p_card, e_card), (m_cpu, p_cpu, e_cpu) = out["cuda"], out["cpu"]
    assert set(m_card) == set(m_cpu)
    for k in m_cpu:
        np.testing.assert_allclose(m_card[k], m_cpu[k], rtol=1e-4, err_msg=k)
    for n in p_cpu:
        np.testing.assert_allclose(p_card[n].numpy(), p_cpu[n].numpy(), atol=1e-6, rtol=0, err_msg=n)
        np.testing.assert_allclose(e_card[n].numpy(), e_cpu[n].numpy(), atol=1e-6, rtol=0, err_msg=n)


def _tiny_bf16_step(dev, weights, batch, **extra):
    """(metrics, {name: grad}, state) of one dropout-free bfloat16 step of
    the tiny model on ``dev``."""
    from tubedetr_tpu_torch.config import TubeDETRConfig
    from tubedetr_tpu_torch.models.tubedetr import build_model
    from tubedetr_tpu_torch.parallel.train_step import create_train_state, make_train_step, to_device

    cfg = TubeDETRConfig(
        backbone="resnet26", hidden_dim=32, nheads=4, enc_layers=1, dec_layers=2,
        dim_feedforward=64, video_max_len=8, video_max_len_train=8, stride=2,
        max_text_len=8, text_vocab_size=128, text_hidden_size=32, text_layers=1,
        text_heads=4, text_ffn=64, text_max_positions=40, batch_size=2, ema=True,
        ema_decay=0.9, compute_dtype="bfloat16", **extra)
    model = build_model(cfg, device=dev)
    if weights is not None:
        model.load_state_dict(weights)
    state = create_train_state(cfg, model)
    step = make_train_step(cfg, deterministic=True)
    total, _ = step.forward_loss(state, to_device(batch, torch.device(dev)))
    total.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters() if p.grad is not None}
    state.optimizer.zero_grad(set_to_none=True)
    lrs = {"lr": 1e-3, "lr_backbone": 1e-4, "lr_text_encoder": 1e-3}
    state, metrics = step(state, batch, lrs, 0)
    return {k: float(v) for k, v in metrics.items()}, grads, state


def _tiny_batch():
    from tubedetr_tpu_torch.data.collate import collate
    from tubedetr_tpu_torch.data.synthetic import make_synthetic_sample

    samples = [make_synthetic_sample(i, t=8 - i, vocab=128) for i in range(2)]
    return collate(samples, 8, 2, 8)


def test_bf16_train_step_on_the_card_keeps_float32_state():
    """One bfloat16 step of a tiny model on the card: every loss term
    finite and within 5e-2 (relative) of the CPU's bfloat16 step from the
    same weights (cuDNN and oneDNN sum in other orders, and bfloat16 keeps
    8 bits); parameters, gradients, AdamW moments and the EMA float32."""
    require_cuda()
    batch = _tiny_batch()
    torch.manual_seed(0)
    m_cpu, _, state_cpu = _tiny_bf16_step("cpu", None, batch)
    torch.manual_seed(0)  # the same init on the card
    m_card, grads, state = _tiny_bf16_step("cuda", None, batch)
    assert set(m_card) == set(m_cpu)
    for k in m_cpu:
        assert np.isfinite(m_card[k]), k
        np.testing.assert_allclose(m_card[k], m_cpu[k], rtol=5e-2, err_msg=k)
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    assert all(g.dtype == torch.float32 for g in grads.values())
    assert all(v.dtype == torch.float32 for st in state.optimizer.state.values()
               for v in st.values() if torch.is_tensor(v) and v.dim() > 0)
    assert all(v.dtype == torch.float32 for v in state.ema_params.values())


def test_remat_policies_give_equal_gradients_on_the_card():
    """``full``, ``save_mid``, ``save_acts`` and remat off: bit-equal
    bfloat16 gradients on the card with deterministic cuDNN and kernels."""
    require_cuda()
    batch = _tiny_batch()
    torch.manual_seed(0)
    from tubedetr_tpu_torch.config import TubeDETRConfig
    from tubedetr_tpu_torch.models.tubedetr import build_model

    weights = build_model(TubeDETRConfig(backbone="resnet26", hidden_dim=32, nheads=4,
                                         enc_layers=1, dec_layers=2, dim_feedforward=64,
                                         video_max_len=8, video_max_len_train=8, stride=2,
                                         max_text_len=8, text_vocab_size=128,
                                         text_hidden_size=32, text_layers=1, text_heads=4,
                                         text_ffn=64, text_max_positions=40),
                          device="cpu").state_dict()
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        runs = {p: _tiny_bf16_step("cuda", weights, batch, remat_policy=p)[1]
                for p in ("full", "save_mid", "save_acts")}
        runs["off"] = _tiny_bf16_step("cuda", weights, batch, remat_backbone=False)[1]
    finally:
        torch.backends.cudnn.deterministic = saved
        torch.use_deterministic_algorithms(False)
    for name, grads in runs.items():
        assert sorted(grads) == sorted(runs["full"]), name
        for n, g in grads.items():
            assert torch.equal(g, runs["full"][n]), (name, n)


# the train CLI's layer maps at resolution 224 for 360x640 clips: the eval
# transform gives 210x373 frames; serving pads them to 224x384 (K1's bucket),
# the data path does not (as the JAX package's collate)
K2_CLI_MAPS = {  # (height, width, planes)
    "bucketed-layer1": (56, 96, 64), "bucketed-layer2": (28, 48, 128),
    "bucketed-layer3": (14, 24, 256), "bucketed-layer4": (7, 12, 512),
    "data-layer1": (53, 94, 64), "data-layer2": (27, 47, 128),
}


@pytest.mark.parametrize("case", list(K2_CLI_MAPS))
def test_k2_exact_at_the_cli_layer_maps(case):
    """K2 equals its plain version bit for bit at the layer maps of the CLI's
    int8 eval and of a reload request at resolution 224, one launch each."""
    require_cuda()
    h, w, planes = K2_CLI_MAPS[case]
    xq, fold = k2_inputs(8, h, w, planes, seed=5)
    cfold = fold_to(fold, "cuda")
    before = fused_bottleneck_block.launches
    out, so = fused_bottleneck_block(xq.cuda(), cfold, 1)
    torch.cuda.synchronize()
    assert fused_bottleneck_block.launches == before + 1
    assert float(so) == float(fold.so)
    assert torch.equal(out.cpu(), fused_bottleneck_plain(xq.cuda(), cfold, 1).cpu())


def test_device_prefetcher_on_the_card_matches_a_synchronous_copy():
    """Pinned batches copied on the prefetcher's side stream give, on the
    consumer's default stream, the tensors of a synchronous ``.to("cuda")``;
    the consumer's work runs on the default stream while the next copies
    run on the side stream, and the freed batches' memory is not handed
    back under a step that still reads it (each step checks its batch
    after a long kernel)."""
    require_cuda()
    from tubedetr_tpu_torch.data.loader import DataLoader, DevicePrefetcher
    from tubedetr_tpu_torch.data.synthetic import SyntheticDataset

    ds = SyntheticDataset(n=9, t=8, h=96, w=128, seed=2, vocab=128)
    kw = dict(batch_size=2, t=8, stride=2, max_text_len=6)
    sync = [({k: torch.as_tensor(v).cuda() for k, v in b.items()}, m)
            for b, m in DataLoader(ds, **kw)]
    feed = DevicePrefetcher(DataLoader(ds, num_workers=2, pin_memory=True, **kw), size=2)
    big = torch.randn(4096, 4096, device="cuda")
    seen = 0
    for (batch, meta), (want, want_meta) in zip(feed, sync):
        assert torch.cuda.current_stream() == torch.cuda.default_stream()
        assert meta == want_meta
        for _ in range(3):  # a slow step on the default stream
            big = torch.tanh(big @ big / 64)
        for k, v in want.items():
            assert batch[k].device.type == "cuda"
            assert torch.equal(batch[k], v), k
        seen += 1
    assert seen == len(sync) == 5
    assert torch.isfinite(big).all()


# ---------------------------------------------------------------------------
# multi-GPU: a process group of NCCL on the card
# ---------------------------------------------------------------------------


def _tiny_dist_setup(tmp_path):
    """(config, weights file, the four videos' batch) of ``tests/torch_dist_ranks.py``."""
    import torch_dist_ranks as R  # beside this file (pytest puts tests/ on the path)
    from tubedetr_tpu_torch.models.tubedetr import build_model

    torch.manual_seed(0)
    cfg = R.cfg_of(device="cuda")
    path = str(tmp_path / "weights.pt")
    torch.save(build_model(cfg, device="cpu").state_dict(), path)
    return cfg, path


@pytest.mark.parametrize("name", ["ddp", "zero", "fsdp"])
def test_one_rank_nccl_step_equals_the_unwrapped_step(tmp_path, name):
    """A one-rank NCCL group (every collective the identity) around DDP,
    ZeRO-1 or FSDP: one dropout-free AdamW step of the tiny model gives the
    unwrapped step's loss terms and grad norm within rtol 1e-5 (cuDNN's
    backward may add in another order from run to run), the gradients
    within atol 1e-6 and the parameters within the AdamW first-step bound of
    ``tests/test_torch_dist.py``."""
    require_cuda()
    import torch.distributed as dist

    import torch_dist_ranks as R  # beside this file (pytest puts tests/ on the path)
    from tubedetr_tpu_torch.parallel.dist import init_process_group
    from tubedetr_tpu_torch.parallel.mesh import make_mesh

    cfg, path = _tiny_dist_setup(tmp_path)
    extra = {"zero": {"shard_optimizer_state": True}, "fsdp": {"shard_params": True}}.get(name, {})
    batch = R.batch_of()
    ref = R._strip(R.run_steps(cfg, path, batch, device="cuda"))
    init_process_group(torch.device("cuda"), 0, 1, f"file://{tmp_path}/store")
    try:
        res = R._strip(R.run_steps(cfg.replace(**extra), path, batch, make_mesh(1, 1, "cuda"),
                                   device="cuda"))
    finally:
        dist.destroy_process_group()
    R.assert_step_matches(res, ref, R.labels_of(cfg))


def test_k2_on_a_second_card_is_exact():
    """K2 launched on cuda:1 while cuda:0 is current (the wrapper enters the
    tensor's device, so the SM count and the stream are cuda:1's) equals
    its plain version bit for bit. Skips with fewer than 2 cards."""
    require_cuda()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 cards: this is K2 on a card other than device 0")
    xq, fold = k2_inputs(4, 22, 38, 256, seed=3)
    torch.cuda.set_device(0)
    cfold = fold_to(fold, "cuda:1")
    before = fused_bottleneck_block.launches
    out, so = fused_bottleneck_block(xq.to("cuda:1"), cfold, 1)
    torch.cuda.synchronize(1)
    assert fused_bottleneck_block.launches == before + 1 and out.device == torch.device("cuda:1")
    assert torch.equal(out.cpu(), fused_bottleneck_plain(xq, fold, 1))


def test_two_rank_nccl_steps_match_one_card(tmp_path):
    """Two ranks on two cards (NCCL), each on half the batch: DDP and FSDP
    give the one-card step on the whole batch (``tests/test_torch_dist.py``'s
    bounds). Skips with fewer than 2 cards."""
    require_cuda()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 cards: NCCL puts no two ranks of a group on one card")
    import torch_dist_ranks as R  # beside this file (pytest puts tests/ on the path)

    cfg, path = _tiny_dist_setup(tmp_path)
    ref = R._strip(R.run_steps(cfg, path, R.batch_of(), device="cuda"))
    ranks = R.spawn(R.nccl_ranks, 2, tmp_path, path, device="cuda")
    for res in ranks:
        for name in ("ddp", "fsdp"):
            R.assert_step_matches(res[name], ref, R.labels_of(cfg))


@pytest.mark.parametrize("name", ["tp", "tp_zero", "tp_fsdp"])
def test_one_rank_nccl_tp_step_matches_the_unwrapped_step(tmp_path, name):
    """The model axis engaged on a one-rank NCCL model group (every layer's
    f and g run, each the identity) alone, with ZeRO-1 and with FSDP: one
    dropout-free step of the tiny model against the unwrapped one, the
    loss terms and grad norm within rtol 1e-5 and the gradients within
    ``tests/test_torch_tp.py``'s bounds (the row-parallel bias is added
    after the product, the head mean is a sum over the group)."""
    require_cuda()
    import torch.distributed as dist

    import torch_dist_ranks as R  # beside this file (pytest puts tests/ on the path)
    from tubedetr_tpu_torch.parallel.dist import init_process_group
    from tubedetr_tpu_torch.parallel.mesh import make_mesh

    cfg, path = _tiny_dist_setup(tmp_path)
    extra = {"tp_zero": {"shard_optimizer_state": True},
             "tp_fsdp": {"shard_params": True}}.get(name, {})
    batch = R.batch_of()
    ref = R._strip(R.run_steps(cfg, path, batch, device="cuda"))
    init_process_group(torch.device("cuda"), 0, 1, f"file://{tmp_path}/store")
    try:
        res = R._strip(R.run_steps(cfg.replace(**extra), path, batch, make_mesh(1, 1, "cuda", 1),
                                   device="cuda", tp=True))
    finally:
        dist.destroy_process_group()
    assert res["tp_split"]
    for k, v in ref["metrics"][0].items():
        np.testing.assert_allclose(res["metrics"][0][k], v, rtol=1e-5, err_msg=k)
    for n, g in ref["grads"].items():
        np.testing.assert_allclose(res["grads"][n], g, rtol=5e-4, atol=5e-5, err_msg=n)


def test_one_rank_nccl_pipeline_matches_the_sequential_encoder(tmp_path):
    """pipe=1 on a one-rank NCCL group, 4 microbatches: the tiny config's
    encoder stack (2 layers) pipelined equals the sequential stack, forward
    and the gradients of the layers and of the input (atol 1e-5)."""
    require_cuda()
    import torch.distributed as dist

    from tubedetr_tpu_torch.models.transformer import Encoder
    from tubedetr_tpu_torch.parallel.dist import init_process_group
    from tubedetr_tpu_torch.parallel.pp import make_pipe_mesh, pipelined_encoder_apply

    torch.manual_seed(0)
    enc = Encoder(2, 32, 4, 64).cuda()
    x = torch.randn(8, 10, 32, device="cuda", requires_grad=True)
    pos = torch.randn(8, 10, 32, device="cuda") * 0.3
    mask = torch.rand(8, 10, device="cuda") > 0.8
    mask[:, 0] = False
    ref = enc(x, pos, mask)
    ref.square().mean().backward()
    want = [x.grad.clone()] + [p.grad.clone() for p in enc.parameters()]
    x.grad = None
    enc.zero_grad(set_to_none=True)
    init_process_group(torch.device("cuda"), 0, 1, f"file://{tmp_path}/store")
    try:
        out = pipelined_encoder_apply(enc.layers, x, pos, mask, mesh=make_pipe_mesh(1, 1),
                                      microbatches=4)
        out.square().mean().backward()
    finally:
        dist.destroy_process_group()
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    for g, w in zip([x.grad] + [p.grad for p in enc.parameters()], want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)


def test_maybe_profile_traces_the_cards_kernels(tmp_path):
    """On the card ``maybe_profile`` records CUDA activities: its Chrome
    trace holds the kernel events of a matmul."""
    require_cuda()
    import json
    import os

    from tubedetr_tpu_torch.utils.misc import maybe_profile

    x = torch.randn(512, 512, device="cuda")
    with maybe_profile(str(tmp_path)):
        (x @ x).sum().item()
    (name,) = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "kernel" for e in events)


# G1: (N, H, W, C, k, stride, groups, the launcher's path), O = C as in the
# timm trunks. Heights and widths are no multiple of a tile (4 x 8*TX
# depthwise, about 128 pixels grouped), so tiles and tap windows cross the
# frame's edges; "-bytes" cases stage bytes (channels no multiple of 16)
G1_CASES = {
    "dw-k3-s1": (2, 33, 47, 96, 3, 1, 96, "depthwise"),
    "dw-k3-s2": (2, 33, 47, 144, 3, 2, 144, "depthwise"),
    "dw-k5-s1": (1, 19, 21, 240, 5, 1, 240, "depthwise"),
    "dw-k5-s2": (1, 19, 21, 672, 5, 2, 672, "depthwise"),
    "dw-k3-s1-wide": (1, 11, 131, 48, 3, 1, 48, "depthwise"),
    "dw-k5-s2-tiny": (3, 3, 2, 32, 5, 2, 32, "depthwise"),
    "dw-k3-s1-bytes": (2, 9, 13, 24, 3, 1, 24, "depthwise-bytes"),
    "dw-k5-s2-bytes": (1, 7, 9, 7, 5, 2, 7, "depthwise-bytes"),
    "g8-k3-s1": (2, 22, 38, 64, 3, 1, 8, "grouped-mma"),
    "g8-k3-odd": (3, 5, 7, 24, 3, 1, 3, "grouped-mma"),
    "g16-k3-s1": (2, 22, 38, 128, 3, 1, 8, "grouped-mma"),
    "g16-k3-s2": (2, 22, 38, 320, 3, 2, 20, "grouped-mma"),
    "g16-k3-s2-wide": (1, 15, 151, 64, 3, 2, 4, "grouped-mma"),
    "g16-k5-s1": (1, 9, 11, 32, 5, 1, 2, "grouped-mma"),
    "g24-k3-s1": (1, 11, 19, 96, 3, 1, 4, "grouped-mma"),
    "g24-k3-s2": (2, 13, 9, 48, 3, 2, 2, "grouped-mma"),
    "g48-k3-s2": (1, 11, 13, 96, 3, 2, 2, "grouped-mma"),
    "g48-k3-s1": (1, 11, 19, 768, 3, 1, 16, "grouped-mma"),
    "g4-k3-general": (1, 7, 9, 12, 3, 1, 3, "general"),
    "dw-k7-general": (1, 9, 10, 16, 7, 2, 16, "general"),
}


def g1_operands(case: str, dtype: torch.dtype):
    n, h, w, c, k, stride, groups, _ = G1_CASES[case]
    gen = torch.Generator().manual_seed(6)
    xq = torch.randint(-127, 128, (n, h, w, c), dtype=torch.int8, generator=gen)
    wq = torch.randint(-127, 128, (c, k * k * (c // groups)), dtype=torch.int8, generator=gen)
    # per-channel scales of the trunks' magnitude, each its own float32
    scale = (torch.rand(c, generator=gen, dtype=torch.float64) * 1e-4 + 1e-6).float()
    return xq, wq, k, stride, groups, scale, dtype


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", list(G1_CASES))
def test_g1_kernel_matches_plain(case, dtype):
    """G1 takes the expected path and equals its plain version (the int32
    conv, then the fold) bit for bit, on the card and on the CPU; one launch
    a call."""
    require_cuda()
    xq, wq, k, stride, groups, scale, dt = g1_operands(case, getattr(torch, dtype))
    assert g1_path(xq.cuda(), wq.cuda(), k, stride, groups) == G1_CASES[case][-1]
    before = grouped_conv2d_int8.launches
    got = grouped_conv2d_int8(xq.cuda(), wq.cuda(), k, stride, groups, scale.cuda(), dt)
    torch.cuda.synchronize()
    assert grouped_conv2d_int8.launches == before + 1
    assert got.dtype == dt and got.is_contiguous()
    ref = grouped_conv2d_int8_plain(xq, wq, k, stride, groups, scale, dt)
    assert torch.equal(got.cpu(), ref)
    assert torch.equal(got, grouped_conv2d_int8_plain(xq.cuda(), wq.cuda(), k, stride, groups,
                                                      scale.cuda(), dt))


def test_g1_takes_misaligned_bases():
    """Operands one byte past an aligned base take the byte-staged or
    general path, and still equal the plain version."""
    require_cuda()
    for case in ("dw-k3-s1", "g16-k3-s1"):
        xq, wq, k, stride, groups, scale, dt = g1_operands(case, torch.bfloat16)
        xm = torch.empty(xq.numel() + 1, dtype=torch.int8, device="cuda")[1:].view(xq.shape)
        xm.copy_(xq)
        got = grouped_conv2d_int8(xm, wq.cuda(), k, stride, groups, scale.cuda(), dt)
        assert torch.equal(got.cpu(), grouped_conv2d_int8_plain(xq, wq, k, stride, groups,
                                                                scale, dt))


def test_g1_rejects_what_it_cannot_take():
    require_cuda()
    xq = torch.zeros((1, 4, 4, 8), dtype=torch.int8, device="cuda")
    wq = torch.zeros((8, 9 * 4), dtype=torch.int8, device="cuda")
    scale = torch.ones(8, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        grouped_conv2d_int8(xq.transpose(1, 2), wq, 3, 1, 2, scale, torch.float32)
    with pytest.raises(ValueError, match="devices"):
        grouped_conv2d_int8(xq, wq.cpu(), 3, 1, 2, scale, torch.float32)
    with pytest.raises(ValueError, match="devices"):
        grouped_conv2d_int8(xq, wq, 3, 1, 2, scale.cpu(), torch.float32)
    with pytest.raises(ValueError, match="scale"):
        grouped_conv2d_int8(xq, wq, 3, 1, 2, scale.half(), torch.float32)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        grouped_conv2d_int8(xq, wq, 3, 1, 2, scale, torch.float16)
