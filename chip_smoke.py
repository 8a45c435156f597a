#!/usr/bin/env python3
"""Drive the PyTorch port (``tubedetr_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero before the last
line:

1. the card's name and power limit (``nvidia-smi``) and the CUDA version;
2. build every hand-written kernel from ``tubedetr_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together);
3. hold each kernel to its plain PyTorch version on the card and time the
   kernel, the plain version and a PyTorch yardstick with CUDA events: K1
   (resize+normalize) at the serving shape, also padded to the bucket grid
   as the pipeline asks for it (its registers and spills from the build
   log; a spill fails), K2 (the fused int8 bottleneck)
   exactly at the four ResNet-101 tail shapes at 352x608 and the DC5 one
   with 16 frames, and exactly again, and timed, at the serving batch of
   N=400 frames;
4. the main paths at full width: ``GroundingPipeline`` with the bench
   headline model (ResNet-101, RoBERTa-base, res 352, T=200, stride 4, fast
   and sted on, weights from a seed) serves two requests through
   ``ground_many`` and one through ``ground``: float bf16, float f32,
   int8_static + fused_bottleneck (K2 on every stride-1 tail) in bf16, and
   int8_static unfused in bf16. Each path's kernel launch counts are zeroed
   just before it and read just after;
5. small requests through the pipeline on the card and on the CPU (the
   plain path), float, int8_static + fused and int8_qat on the int8
   model's scales, which must agree;
6. the serving path, the port's HTTP ``Server`` (``apps/serve.py``) at full
   width on the card: the int8_static + K2 model with ``serve_max_batch=2``
   and a 50 ms window behind a ``ThreadingHTTPServer`` on a local port; a
   cold request (calibration inside), two requests at once from two client
   threads (one forward), one request alone, each answer held to
   ``ground_many`` called directly on the same requests; ``/healthz``,
   ``/stats``, a video outside the root (403), and ``drain`` (503 after).
   K1 once a request and K2 29 times a backbone pass, counted over the HTTP
   requests alone;
7. the other inference configurations: each ``fast_mode`` (gating,
   transformer, pool, noslow), ``num_queries=3``, the model flags
   (``learned``, ``v2``, ``v3``, ``no_tsa``, ``learn_time_embed``,
   ``no_time_embed``) and the GroupNorm trunk on the small config, card
   against CPU on the same frames (the selectors' winners equal), the
   tubes scored by ``VIoUEvaluator`` on both; ``fast_mode="transformer"``
   at full width in bf16, one warm B=2 call; ``learned`` +
   ``learn_time_embed`` and ``no_tsa`` + ``no_time_embed`` at full width in
   int8_static + K2 (a cold and a warm B=2 call each, K1 once a request and
   held to its plain version on the request's frames, K2 29 times a pass
   and exact on the inputs it got); ``resnet101-gn`` at full width in bf16,
   one training step and one serving call;
7b. the timm trunks (``phase_timm``, ``[timm]``, ``[g1]``,
   ``[timm-small]``, ``[timm-train]``): EfficientNet-B0, RegNetY-008 and
   ConvNeXt-T with the headline model's transformer and RoBERTa-base at
   full width, each in bf16 and in int8_static with ``fused_bottleneck``
   on (a cold and a warm B=2 ``ground_many``: tubes in range, K1 once a
   request and held to its plain version on a request's frames, K2 never,
   G1 ``G1_PER_PASS`` times a trunk pass, calibration included); G1 held
   exactly to its plain version on every input shape those legs gave it,
   cut to one request's 200 frames, and timed beside the plain version and
   a float32 cuDNN grouped conv of the same shape; each family on the small
   config card against CPU, float and int8_static; one bf16 step of the
   published training config with each family (every trunk parameter's
   gradient finite and non-zero, the FrozenBN buffers unchanged), and one
   float32 ``int8_qat`` + ``backbone_quant_fast int8_static`` step with
   EfficientNet-B0 (its fast pass: G1 16 launches);
8. training (``phase_train_small``, ``phase_train``): one small
   dropout-free train step (B=2, ragged durations, fast branch,
   ``grad_accum=2``, AdamW, EMA) card against CPU from the same weights and
   batch (loss terms and grad norm to ``TRAIN_LOSS_RTOL``, the parameters to
   ``adamw_atol``), then ``evaluate`` on both over a synthetic val set cut
   by ``div_vid`` (vIoU within 1e-3); then ``train_one_epoch`` for
   ``TRAIN_STEPS`` steps of the published training config at full width
   (ResNet-101, RoBERTa-base, 200 frames of 224x398, stride 5, f32 without
   TF32, dropout, AdamW with ``linear_with_warmup``, EMA, remat): every loss
   term finite under ``loss_weight_dict``'s keys, the stem, layer1 and every
   FrozenBN buffer unchanged bit for bit, layer2-4, the transformer and the
   text encoder changed, the LRs of the steps ``current_lrs``'s, K1 and K2
   never launched. The ``[train]`` line: cold and warm step, the split into
   forward + loss, backward and clip + optimizer + EMA, the trunk's passes
   alone, peak memory with remat on and off, the pre-clip grad norms, beside
   the card's name and power limit; ``[train-profile]``: one warm step under
   ``torch.profiler``; ``[train-bf16]``: the same epoch in bfloat16 compute
   with float32 state (parameters, gradients, AdamW moments and EMA checked
   float32, bfloat16 activations seen by hooks, the frozen tensors
   unchanged), its split, trunk passes and peak beside the float32 ones,
   and the step-0 dropout-free loss in both dtypes; ``[remat]``: each
   ``remat_policy`` (full, save_mid, save_acts, off) in bfloat16, the
   forward + backward seconds and peak memory, the gradients equal to the
   bit with deterministic kernels; ``[train-quant]``: the quantized training
   passes in bfloat16 on the same videos and weights (``int8_qat``, and the
   float trunk with its fast pass and frozen prefix int8_static: each
   calibrated on the first batch, ``QUANT_STEPS`` steps, the split, trunk
   passes and peak, the frozen tensors unchanged, K1 and K2 never
   launched; the fast pass equal to the bit to an int8_static trunk's
   features), the drift probe and one recalibration after the QAT steps,
   the deploy leg (the QAT checkpoint reloaded by an int8_static + K2
   ``GroundingPipeline`` at serving width: its scales, no calibration, K1
   once, K2 29 times and exact), and ``resnet101-gn`` under int8_static at
   serving width (a B=1 call, K2 never launched);
9. the train CLI (``phase_cli``, ``phase_cli_small``): ``apps/train.py:main``
   at the published training config over a VidSTG-layout set it writes (4
   train and 2 val videos of 200 frames of 360x640): one epoch with three
   loader threads and the side-stream prefetcher (one warm step traced),
   eval and vIoU, ``checkpoint.pth``; ``--resume`` of it for epoch 1 (the
   step count continued); an ``--eval --load`` with int8_static and K2 (29
   launches a val forward, K2 held exactly to its plain version on the
   inputs it got); ``GroundingPipeline.reload`` of the checkpoint with the
   eval's scales embedded and one request (no calibration; K1 once, K2 29
   times, K2 exact again). The ``[cli]`` line: host seconds a sample, the
   loader's wait a step with ``--device_prefetch`` 2 and 0, the warm CLI
   step and the frame sizes sampled, one batch's upload pinned and
   pageable, the traced step's device busy share, peak memory, the
   seconds a checkpoint save blocks (sync and async), vIoU, launches; then
   ``[cli-small]``: the tiny CLI card against CPU (``log.txt`` losses within
   ``TRAIN_LOSS_RTOL``, vIoU within 1e-3);
10. several cards (``phase_dist``): a process a card
   (``torch.cuda.device_count()``, spawned), NCCL, the published training
   config with one video a card: rank 0's one-rank reference, then DDP,
   ZeRO-1 and FSDP over every card (on 4 cards also data=2 x time=2), then
   the model axis (``[dist-tp]``: on one card TP, TP + ZeRO-1 and TP + FSDP
   on a one-rank model group, the layers' f and g engaged; on 4 data=2 x
   model=2 under TP + FSDP and TP + ZeRO-1, and model=4), each held to the
   reference within ``TRAIN_LOSS_RTOL``, each with one more step's
   collective inventory (``[dist-comms]``: kind, axes, bytes a rank; the
   profiler's count must equal it); the int8_static + K2 eval with the
   frames split over the cards and the tensor-parallel one, K2 exact with
   29 launches on every rank; and ``[dist-pp]``: the published encoder and
   decoder stacks (6 layers each) pipelined (pipe=1 with 4 microbatches on
   one card, pipe=2 x data=2 on 4) against the sequential stacks, forward
   and gradients within ``PP_RTOL`` on the same microbatches and
   ``PP_WHOLE_BATCH_RTOL`` on the whole batch; then one bfloat16 step
   under DDP and one under FSDP against the unwrapped bfloat16 step
   (``TRAIN_BF16_RTOL``). With one card it checks the wiring
   (every collective is the identity); the ``[dist]`` lines give each
   rank's warm step, peak memory and, on several cards, NCCL's share of a
   traced step;
10b. the measuring entry points of ``scripts/`` (``phase_prof``, ``[prof]``,
   ``tubedetr_tpu_torch/probes``), each at its script's shapes: the
   per-stage trunk profile of ResNet-101 (``stages=N``) in bf16 and in
   int8_static with K2 (its launches in one call of each cut 0, 2, 5, 27,
   29; the whole int8 trunk's top device operations from one traced call)
   and of EfficientNet-B0 in int8_static (G1 16 a whole call); K2 against the
   unfused int8 block at layer3 and layer4 (within the tests' bound of the
   float32 unfused block); the train step split by part (``attribution_ms``);
   int8_static with K2 against float at full width (K2 29 a trunk pass); the
   int8 conv routes conv by conv; K1 against the einsum resize routes (K1
   held to its plain version first); the host staging rates against this
   phase's own train step and trunk;
11. the probes P1-P5 (``tubedetr_tpu_torch/probes``): both entry points at
   the scripts' full shapes with their launch counts zeroed just before and
   read just after, each kernel held exactly to its plain version, and
   noshift and convonly timed beside K2 at layer3's serving shape. They run
   after the serving phases so that their GBs of inputs cannot move those.
   P4 and P5 run K2's kernel (P5 in its flat layout). For P1-P3 and P5 the
   entries also carry the kernel's registers, spills and shared memory (its
   build log; a spill or an ignored ``setmaxnreg`` fails), for P1-P3 the
   wrapper's host microseconds a call.

Then the script's seconds, one ``kernels`` JSON line (each kernel's
``launches`` counted on phase 6's path, G1's on the int8_static legs of
phase 7b, and by path: serve, the int8 + K2
pipeline, train, train in bf16, the model flags' int8 + K2 legs, the CLI's
int8 eval and its reload request, the quantized training legs and the QAT
deploy request, K2's on
rank 0's time-split and tensor-parallel evals of phase 10, and those of
the ``[prof]`` entry points of phase 10b), the
``nvidia-smi`` line again, and,
last, the ``ok`` JSON line. There is no CPU path: without a card the script exits 2.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core peak
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak

# K1 at the serving shape: 200 frames of 360x640 -> 330x586 at res 352
K1_SHAPE = (200, 360, 640, 3)
K1_OUT = (330, 586)
K1_PAD = (352, 608)  # the SIZE_BUCKET grid the pipeline pads to
K1_CROP = (12, 20, 300, 560)
K1_FLOPS_PER_OUT = 11  # 6 for the two row lerps, 3 for the column lerp, 2 affine
F32_ATOL = 1e-4  # two f32 contractions summed in another order than the gather
SMALL_ATOL = 1e-3  # card (cuDNN, cuBLAS, no TF32) vs CPU through a whole small model

# K2: the ResNet-101 stride-1 tails at 352x608 (C, P, H, W, dilation, tails
# per backbone pass) and the DC5 layer4 (checked, not on the main path)
K2_STAGES = {
    "layer1": (256, 64, 88, 152, 1, 2),
    "layer2": (512, 128, 44, 76, 1, 3),
    "layer3": (1024, 256, 22, 38, 1, 22),
    "layer4": (2048, 512, 11, 19, 1, 2),
    "layer4-dc5": (2048, 512, 22, 38, 2, 0),
}
K2_CHECK_FRAMES = 16
K2_TIME_FRAMES = 400  # B=2 x T=200: one shared backbone pass
K2_PER_PASS = 29  # 2 + 3 + 22 + 2 tails in ResNet-101
# card vs CPU on the small int8 request, same scales and frames: the float
# stem conv (cuDNN vs oneDNN) sums in another order, so a value one ulp from
# an int8 rounding boundary flips one step of that tensor's scale, and the
# flip moves what follows it. The trunk's output may differ by at most
# SMALL_INT8_STEPS steps of its own scale; the heads' outputs by the atol.
SMALL_INT8_STEPS = 4
SMALL_INT8_ATOL = {"pred_boxes": 1e-3, "pred_sted": 1e-3}
# the small QAT model card vs CPU on the int8 model's scales: every conv is a
# float conv (cuDNN vs oneDNN sum in other orders), so flipped roundings move
# more of the trunk than in the int8 model; the trunk's outputs are held by
# correlation (tests/test_torch_int8.py's trunk bound) and the heads' by the
# JAX package's QAT-vs-int8_static bound (tests/test_qat.py)
SMALL_QAT_CORR = 0.999
SMALL_QAT_ATOL = {"pred_boxes": 5e-3, "pred_sted": 5e-3}
# a small int8_static timm model card vs CPU: float ops sit between every
# two int8 convs, so a value one ulp from an int8 rounding boundary flips a
# step, and the flip moves every quantized conv after it (squeeze-excite
# gates scale a whole channel). The gate is set from the noise floor
# measured in the same run: the CPU model against itself with the input of
# every int8 quantizer moved by at most one float32 ulp (``QuantNoise``),
# worst of SMALL_TIMM_NOISE_DRAWS draws. Card vs CPU may lie
# SMALL_TIMM_TRUNK_X times as far in the trunk's 1 - correlation and
# SMALL_TIMM_HEADS_X times in the boxes' and sted logits' largest
# differences (a maximum of few elements), never held tighter than
# SMALL_INT8_ATOL.
SMALL_TIMM_NOISE_DRAWS = 3
SMALL_TIMM_TRUNK_X = 2.0
SMALL_TIMM_HEADS_X = 3.0

# P1-P5, the probes: the scripts' default specs plus both flat variants, at
# the scripts' full shapes; noshift and convonly again beside K2 at layer3's
# serving shape (seed 22: K2's own layer3 input in phase_k2)
PROBE_SPECS = ("full:2", "noshift:2", "dot2d:2", "convonly:2", "noshift:8", "hwpad:2", "im2col:2")
PROBE_SERVING = K2_STAGES["layer3"][:5]
PROBE_SERVING_SEED = 22
WAIT_S = 600.0  # an HTTP request of the serve phase, the cold one's calibration included
# the train phase: the published config's frames (a 16:9 clip at resolution 224)
TRAIN_T, TRAIN_HW = 200, (224, 398)
TRAIN_STEPS = 6  # train_one_epoch's steps at full width: one cold, five warm
TRAIN_LOSS_RTOL = 1e-4  # card vs CPU, loss terms and grad norm: float32 sums in another order
TRAIN_PARAM_ATOL = 2e-5  # card vs CPU after one AdamW step (tests/test_torch_train.py's bound)
# a bfloat16 step spread over ranks against the unwrapped one, loss terms and grad norm:
# bfloat16 keeps 8 bits, and the ranks' shares (the one-rank step's microbatches) are
# summed in another order
TRAIN_BF16_RTOL = 1e-2
# the CLI phase: train and val videos of a VidSTG-layout set, each clip's frames, and
# the train step traced (0 is the cold one)
CLI_VIDEOS = (4, 2)
CLI_CLIP = (200, 360, 640)
CLI_PROFILE_STEP = 2
# the quantized training phase: steps a leg (one cold, two warm) and the
# frames of the fast pass held bit for bit against an int8_static trunk
QUANT_STEPS = 3
QUANT_CHECK_FRAMES = 16
# the [prof] phase, the measuring entry points of scripts/ at their shapes:
# timed calls a truncation, K2's launches in one call of ResNet-101 cut after
# 0..4 stage groups (the tails of the stages it runs: 2, 3, 22, 2), G1's in
# one call of the whole EfficientNet-B0 int8 trunk, the train-step
# variants' K, the operations listed from the trace, and the bound that
# tests/test_fused_bottleneck.py holds K2 to against the float32 unfused
# block (at most one step apart, over 99% of the outputs equal)
PROF_ITERS = 2
PROF_K2_BY_STAGES = (0, 2, 5, 27, 29)
PROF_G1_B0 = 16
PROF_TRAIN_K = 2
PROF_TOP = 15
PROF_K2_MAX_STEP, PROF_K2_MIN_EQUAL = 1, 0.99


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def synced(fn):
    """(fn(), host seconds) between two ``torch.cuda.synchronize()``."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def bf16_ulp(x):
    """Spacing of bfloat16 numbers at |x| (8 significant bits)."""
    import torch

    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126))) - 7)


def k1_usage():
    """K1's two instantiations (f32 and bf16 out) as ``build_usage`` reads
    the build log."""
    usage = build_usage("resize_normalize")
    out = {}
    for kind, mangled in (("f32", "IfE"), ("bf16", "I13__nv_bfloat16E")):
        found = [v for name, v in usage.items() if "resize_normalize_kernel" + mangled in name]
        if len(found) != 1:
            fail(f"resize_normalize: {len(found)} entries of the {kind} kernel in its build log "
                 f"({list(usage)})")
        out[kind] = found[0]
    return out


def phase_k1():
    """K1 against its plain version at the serving shape, unpadded and
    padded to the bucket grid as the pipeline asks for it; returns the
    kernels-line entry (launch count filled in after the main path)."""
    import torch
    import torch.nn.functional as F

    from tubedetr_tpu_torch.ops.preprocess import norm_affine
    from tubedetr_tpu_torch.ops.resize_normalize import (
        k1_schedule,
        resize_normalize,
        resize_normalize_plain,
    )
    from tubedetr_tpu_torch.probes import cuda_ms

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full f32
    usage = k1_usage()
    gen = torch.Generator().manual_seed(0)
    x = torch.randint(0, 256, K1_SHAPE, dtype=torch.uint8, generator=gen).cuda()
    n, ih, iw, _ = K1_SHAPE
    oh, ow = K1_OUT

    scale, shift = (torch.from_numpy(v).cuda() for v in norm_affine())

    def library(crop, dtype, pad_to):
        src = x if crop is None else x[:, crop[0]:crop[0] + crop[2], crop[1]:crop[1] + crop[3]]
        y = F.interpolate(src.permute(0, 3, 1, 2).float(), size=(oh, ow),
                          mode="bilinear", align_corners=False)
        y = (y.permute(0, 2, 3, 1) * scale + shift).to(dtype)
        return y if pad_to is None else F.pad(y, (0, 0, 0, pad_to[1] - ow, 0, pad_to[0] - oh))

    cases = {}
    for name, crop, dtype, pad_to in (
        ("f32", None, torch.float32, None),
        ("bf16", None, torch.bfloat16, None),
        ("crop_f32", K1_CROP, torch.float32, None),
        ("pad_bf16", None, torch.bfloat16, K1_PAD),
    ):
        ph, pw = pad_to or (oh, ow)
        # over memory filled with garbage, so a pad the kernel misses shows
        torch.full((n, ph, pw, 3), float("nan"), dtype=dtype, device="cuda")
        out = resize_normalize(x, oh, ow, crop=crop, out_dtype=dtype, pad_to=pad_to)
        ref32 = resize_normalize_plain(x, oh, ow, crop, torch.float32, pad_to=pad_to)
        torch.cuda.synchronize()
        if out.shape != (n, ph, pw, 3) or out.dtype != dtype:
            fail(f"K1 {name}: got {tuple(out.shape)} {out.dtype}")
        if pad_to is not None and (bool(out[:, oh:].any()) or bool(out[:, :, ow:].any())):
            fail(f"K1 {name}: a non-zero value in the pad")
        err = (out.float() - ref32).abs()
        if dtype == torch.float32:
            ok, tol = bool((err <= F32_ATOL).all()), f"atol {F32_ATOL}"
        else:  # one bf16 ulp of the f32 plain value, plus the f32 atol: near 0
            # the affine's cancellation leaves the f32 values ~1e-6 apart,
            # more than a bf16 ulp there
            ok = bool((err <= bf16_ulp(ref32) + F32_ATOL).all())
            tol = f"1 bf16 ulp + atol {F32_ATOL}"
        max_abs_err = err.max().item()
        lib_err = (library(crop, dtype, pad_to).float() - ref32).abs().max().item()
        del out, ref32, err
        out_bytes = n * ph * pw * 3 * (2 if dtype == torch.bfloat16 else 4)
        bytes_ms = (x.numel() + out_bytes) / HBM_BYTES_PER_S * 1e3
        ops_ms = n * oh * ow * 3 * K1_FLOPS_PER_OUT / FP32_OPS_PER_S * 1e3
        case = {
            "max_abs_err": max_abs_err,
            "tolerance": tol,
            "out": [n, ph, pw, 3],
            "ms": cuda_ms(lambda: resize_normalize(x, oh, ow, crop=crop, out_dtype=dtype,
                                                   pad_to=pad_to)),
            "plain_ms": cuda_ms(lambda: resize_normalize_plain(x, oh, ow, crop, dtype, pad_to)),
            "library_ms": cuda_ms(lambda: library(crop, dtype, pad_to)),
            "library": "F.interpolate + affine" + (" + F.pad" if pad_to else ""),
            "library_max_abs_err": lib_err,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        }
        sched = k1_schedule(ih, iw, oh, ow, crop, pad_to)
        case.update(rows_per_block=sched.rows_per_block, staged_rows=sched.slots,
                    **entry_usage(usage["bf16" if dtype == torch.bfloat16 else "f32"],
                                  sched.smem_bytes))
        cases[name] = case
        print(f"[k1] {name}: {json.dumps(case)}", flush=True)
        if not ok:
            fail(f"K1 {name} disagrees with its plain version beyond {tol}: "
                 f"max |err| {case['max_abs_err']}")
    head = cases["f32"]
    return {
        "name": "resize_normalize",
        "route": "cuda",
        "source": "tubedetr_tpu_torch/csrc/resize_normalize.cu",
        "replaces": "tubedetr_tpu/ops/pallas_preprocess.py:63",
        "launches": None,
        "max_abs_err": head["max_abs_err"],
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "shape": {"in": list(K1_SHAPE), "out": [n, oh, ow, 3], "out_dtype": "float32"},
        "cases": cases,
    }


def k2_block(c: int, p: int, h: int, w: int, d: int, n: int, seed: int):
    """A seeded int8 stream on the card and the fold of one bottleneck whose
    activation maxima are calibrated on it, as the pipeline calibrates (the
    float block on the dequantized stream)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from tubedetr_tpu_torch.ops.fused_bottleneck import fold_bottleneck

    rng = np.random.RandomState(seed)
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(seed)
    xq = torch.randint(0, 128, (n, h, w, c), dtype=torch.int8, device=dev, generator=gen)
    k = {
        "conv1": rng.randn(1, 1, c, p) / np.sqrt(c),
        "conv2": rng.randn(3, 3, p, p) / np.sqrt(9 * p),
        "conv3": rng.randn(1, 1, p, c) / np.sqrt(p),
    }
    kernels = {name: torch.from_numpy(v.astype(np.float32)).to(dev) for name, v in k.items()}
    norms = {
        name: (torch.from_numpy((0.5 + rng.rand(f)).astype(np.float32)).to(dev),
               torch.from_numpy((0.1 * rng.randn(f)).astype(np.float32)).to(dev))
        for name, f in (("bn1", p), ("bn2", p), ("bn3", c))
    }
    sx = torch.tensor(0.05, device=dev)
    with torch.no_grad():  # float maxima on a few frames
        xf = xq[:4].float() * sx
        y1 = F.relu(xf @ kernels["conv1"][0, 0] * norms["bn1"][0] + norms["bn1"][1])
        y2 = F.conv2d(y1.permute(0, 3, 1, 2), kernels["conv2"].permute(3, 2, 0, 1),
                      padding=d, dilation=d).permute(0, 2, 3, 1)
        y2 = F.relu(y2 * norms["bn2"][0] + norms["bn2"][1])
        y3 = F.relu(y2 @ kernels["conv3"][0, 0] * norms["bn3"][0] + norms["bn3"][1] + xf)
    fold = fold_bottleneck(sx, kernels, norms, y1.amax(), y2.amax(), y3.amax())
    return xq, fold


def phase_k2():
    """K2 against its plain version: exact at every stage shape with 16
    frames, then exact again and timed at N=400 for the four main-path
    stages; returns the kernels-line entry (launch count filled in after the
    main path)."""
    import torch

    from tubedetr_tpu_torch.ops.fused_bottleneck import (
        fused_bottleneck_block,
        fused_bottleneck_plain,
        kernel_plan,
        tile_plan,
        tma_box_bytes,
    )
    from tubedetr_tpu_torch.probes import cuda_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    usage = {p: entry_usage(u) for p, u in k2_usage()["k2"].items()}
    cases = {}
    for i, (name, (c, p, h, w, d, tails)) in enumerate(K2_STAGES.items()):
        model = {}  # printed on the [k2] line, kept out of the kernels line
        plan = tile_plan(w, p, d)
        built = kernel_plan(w, p, d)
        mine = (plan.tw, plan.stages, plan.tiles, plan.q1_rows, plan.smem_bytes)
        if built != mine:
            fail(f"K2 {name}: the kernel's plan {built} is not tile_plan's {mine}")
        xq, fold = k2_block(c, p, h, w, d, K2_CHECK_FRAMES, seed=10 + i)
        out, so = fused_bottleneck_block(xq, fold, d)
        ref = fused_bottleneck_plain(xq, fold, d)
        torch.cuda.synchronize()
        cpu_fold = type(fold)(**{k: v.cpu() for k, v in vars(fold).items()})
        ref_cpu = fused_bottleneck_plain(xq.cpu(), cpu_fold, d)
        err = (out.int() - ref.int()).abs().max().item()
        case = {
            "shape": {"N": K2_CHECK_FRAMES, "H": h, "W": w, "C": c, "P": p, "dilation": d},
            # a band: 64 * tiles positions of the padded grid, tw = W + 2d wide
            "band_positions": plan.band,
            "band_rows": plan.band_rows,
            "ring_stages": plan.stages,
            "q1_rows": plan.q1_rows,
            **usage[p],
            # the plan's dynamic shared memory and the kernel's static
            "smem_bytes": plan.smem_bytes + usage[p]["smem_bytes"],
            "max_abs_err": err,
            "tolerance": "exact",
            "equal_cpu_plain": bool(torch.equal(ref.cpu(), ref_cpu)),
            "out_mean": out.float().mean().item(),
            "out_saturated": (out == 127).float().mean().item(),
            "out_zero": (out == 0).float().mean().item(),
        }
        if err != 0 or not torch.equal(out, ref) or float(so) != float(fold.so):
            fail(f"K2 {name}: differs from its plain version, max |err| {err}")
        if not case["equal_cpu_plain"]:
            fail(f"K2 {name}: the plain version differs between the card and the CPU")
        del xq, out, ref, ref_cpu
        if tails:  # a main-path stage: check and time it at the serving batch
            n = K2_TIME_FRAMES
            xq, fold = k2_block(c, p, h, w, d, n, seed=20 + i)
            out, so = fused_bottleneck_block(xq, fold, d)
            ref = fused_bottleneck_plain(xq, fold, d)
            err = (out.short() - ref.short()).abs().max().item()
            case["max_abs_err_timed"] = err
            if err != 0 or not torch.equal(out, ref) or float(so) != float(fold.so):
                fail(f"K2 {name} at N={n}: differs from its plain version, max |err| {err}")
            del out, ref
            weights = c * p + 9 * p * p + p * c
            nbytes = 2 * n * h * w * c + weights + 4 * (4 * p + 2 * c + 1)
            ops = 2 * n * h * w * weights
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = ops / INT8_OPS_PER_S * 1e3
            case.update({
                "timed_frames": n,
                "tails_per_pass": tails,
                "ms": cuda_ms(lambda: fused_bottleneck_block(xq, fold, d), groups=11, per_group=5),
                "plain_ms": cuda_ms(lambda: fused_bottleneck_plain(xq, fold, d),
                                    groups=5, per_group=2),
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            })
            case["tops"] = ops / case["ms"] / 1e9
            # the bytes K2's TMA boxes ask for a launch, counted from the
            # tiling: a model, not a reading of the card
            model["tma_box_bytes_model"] = tma_box_bytes(plan, n, h, c)
            del xq
            torch.cuda.empty_cache()
        cases[name] = case
        print(f"[k2] {name}: {json.dumps({**case, **model})}", flush=True)
    timed = [v for v in cases.values() if "ms" in v]

    def per_pass(key):
        return sum(v[key] * v["tails_per_pass"] for v in timed)

    ms, bound = per_pass("ms"), per_pass("bound_ms")
    by_ops = sum(v["tails_per_pass"] * v["bound_ms"] for v in timed
                 if v["bound_by"] == "operations")
    entry = {
        "name": "fused_bottleneck",
        "route": "cuda",
        "source": "tubedetr_tpu_torch/csrc/fused_bottleneck.cu",
        "replaces": "tubedetr_tpu/ops/fused_bottleneck.py:60",
        "launches": None,
        "max_abs_err": max(max(v["max_abs_err"], v.get("max_abs_err_timed", 0))
                           for v in cases.values()),
        # one ResNet-101 backbone pass at B=2, T=200: 29 launches summed
        "ms": ms,
        "plain_ms": per_pass("plain_ms"),
        "bound_ms": bound,
        "bound_by": "operations" if by_ops >= bound - by_ops else "bytes",
        # no one PyTorch call computes a whole int8 bottleneck (the plain
        # version, the unfused int8 route on cuBLASLt, is in plain_ms)
        "library_ms": None,
        "per": f"one backbone pass: {K2_PER_PASS} launches at N={K2_TIME_FRAMES}",
        "cases": cases,
    }
    print(f"[k2] per pass: {ms:.3f} ms (bound {bound:.3f} ms, plain {entry['plain_ms']:.3f} ms)",
          flush=True)
    return entry


def bound(nbytes: float, ops: float, ops_per_s: float):
    """(bound ms, what bounds it): the larger of bytes over the memory rate
    and operations over the peak rate."""
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def max_err(out, ref) -> float:
    return (out.double() - ref.double()).abs().max().item()


def probe_entry(name, source, replaces, cases, head, library_ms):
    """A kernels-line entry of a probe from its cases (launch count filled in
    by the caller)."""
    c = cases[head]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": None,
        "max_abs_err": max(v["max_abs_err"] for v in cases.values()),
        "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
        "bound_by": c["bound_by"], "library_ms": library_ms, "per": f"one launch, {head}",
        "cases": cases,
    }


def build_usage(lib: str) -> dict:
    """Registers, spills, stack, static shared memory and ptxas notes of each
    kernel entry of ``lib<lib>.so``, from its build log. Fails on a spill in
    any entry or on any ptxas message about ``setmaxnreg`` (it is ignored
    where the roles do not split in one if/else)."""
    from tubedetr_tpu_torch.ops import _cuda_build

    log = _cuda_build.build_log(lib)
    ignored = [line.strip() for line in log.splitlines() if "setmaxnreg" in line]
    if ignored:
        fail(f"{lib}: ptxas on setmaxnreg: {ignored}")
    usage = _cuda_build.ptxas_usage(log)
    for name, u in usage.items():
        if u["spill_store_bytes"] + u["spill_load_bytes"]:
            fail(f"{lib} kernel {name} spills: {u}")
    return usage


def entry_usage(u: dict, dynamic_smem: int = 0) -> dict:
    return {"registers": u["registers"],
            "spill_bytes": u["spill_store_bytes"] + u["spill_load_bytes"],
            "stack_bytes": u["stack_bytes"], "smem_bytes": u["smem_bytes"] + dynamic_smem,
            "ptxas_notes": u["notes"]}


def k2_usage():
    """K2's kernel for each P it is built for, as ``build_usage`` reads the
    build log: K2's
    ``kFull`` instantiation (which the probe's ``noshift`` runs too;
    ``convonly`` has its own) under ``"k2"``, and the flat layout's two (P5's
    ``hwpad`` and ``im2col``) under their names. Fails unless there are 4 P
    x 4 entries: K2's 8 and the flat layout's 8."""
    import re

    usage = build_usage("fused_bottleneck")
    out = {"k2": {}, "convonly": {}, "hwpad": {}, "im2col": {}}
    # Variant 0 kFull, 2 kConvOnly, 3 kIm2col; Layout 0 compact, 1 flat
    kinds = {("0", "0"): "k2", ("2", "0"): "convonly", ("0", "1"): "hwpad", ("3", "1"): "im2col"}
    for name, u in usage.items():
        m = re.search(r"fused_bottleneck_kernelILi(\d+)E\w*?VariantE(\d)E\w*?LayoutE(\d)E", name)
        if m and (m.group(2), m.group(3)) in kinds:
            out[kinds[m.group(2), m.group(3)]][int(m.group(1))] = u
    if any(sorted(v) != [64, 128, 256, 512] for v in out.values()) or len(usage) != 16:
        fail(f"fused_bottleneck: expected 16 kernel entries (4 P x full, convonly, flat hwpad, "
             f"flat im2col) in its build log, found {list(usage)}")
    return out


def probe_mm_usage():
    """The two instantiations of P1-P3's kernel (``s8``: P1 and P3, ``bf16``:
    P2), from ``build_usage``, with the dynamic shared memory the library
    requests."""
    from tubedetr_tpu_torch.ops import probe_mm

    usage = build_usage("probe_mm")
    dynamic = probe_mm.smem_bytes()
    out = {}
    for kind in ("s8", "bf16"):
        found = [v for name, v in usage.items() if f"probe_mm_{kind}_kernel" in name]
        if len(found) != 1:
            fail(f"probe_mm: {len(found)} entries of the {kind} kernel in its build log")
        out[kind] = entry_usage(found[0], dynamic)
    return out


def phase_probes():
    """P1-P5. Their path is the probes' entry points: ``int8_matmul.run`` and
    ``fused_variants.run`` at the scripts' full shapes, launch counts zeroed
    just before and read just after. Then each kernel against its plain
    version on the same inputs (exact: s32 and int8 outputs, and bf16 whose
    integer partial sums stay below 2**24), specs of one function against
    each other, each plain version on the card against the CPU on a small
    case, the plain and library times, and noshift and convonly beside K2 at
    layer3's serving shape. Returns the five kernels-line entries."""
    import numpy as np
    import torch

    from tubedetr_tpu_torch.ops import probe_bottleneck as pb
    from tubedetr_tpu_torch.ops import probe_mm
    from tubedetr_tpu_torch.ops.fused_bottleneck import fused_bottleneck_block, tile_plan
    from tubedetr_tpu_torch.probes import cuda_ms
    from tubedetr_tpu_torch.probes import fused_variants as fv
    from tubedetr_tpu_torch.probes import int8_matmul as im

    torch.backends.cuda.matmul.allow_tf32 = False
    wrappers = {"P1": probe_mm.int8_mm, "P2": probe_mm.bf16_mm, "P3": probe_mm.int8_mm_frames,
                "P4": pb.bottleneck_variant, "P5": pb.flat_bottleneck}
    for fn in wrappers.values():
        fn.launches = 0
    say = lambda line: print(f"[probes] {line}", flush=True)  # noqa: E731
    say("python -m tubedetr_tpu_torch.probes.int8_matmul")
    mm_rows = im.run(out=say)
    say("python -m tubedetr_tpu_torch.probes.fused_variants " + " ".join(PROBE_SPECS))
    fv_rows = fv.run(PROBE_SPECS, out=say)
    launches = {k: fn.launches for k, fn in wrappers.items()}
    say(f"launches on the probes' path: {json.dumps(launches)}")
    for k, v in launches.items():
        if not v:
            fail(f"{k}: its kernel was not launched on the probes' path")

    # ---- P1-P3 at the script's shapes: the F=2 draw
    x, wt = im.make_inputs(np.random.RandomState(0))
    prods = {prod.probe: prod for prod in im.products(x, wt, im.HW, 2)}
    small = {dev: im.make_inputs(np.random.RandomState(1), n_frames=2, device=dev)
             for dev in ("cpu", "cuda")}
    mm_cases = {}
    for key in ("P1", "P2", "P3"):
        prod = prods[key]
        out, ref = prod.call(), prod.plain()
        torch.cuda.synchronize()
        small_plain = {dev: {q.probe: q for q in im.products(*small[dev], im.HW, 2)}[key].plain()
                       for dev in small}
        rate = BF16_OPS_PER_S if key == "P2" else INT8_OPS_PER_S
        bound_ms, bound_by = bound(prod.nbytes, prod.ops, rate)
        timed = {r["F"]: r["ms"] for r in mm_rows if r["probe"] == key}
        case = {
            "shape": {"rows": x.shape[0], "K": x.shape[1], "N": wt.shape[0], "frame_rows": im.HW},
            "max_abs_err": max_err(out, ref), "tolerance": "exact",
            "equal_cpu_plain": bool(torch.equal(small_plain["cuda"].cpu(), small_plain["cpu"])),
            "ms": timed[2], "ms_F8": timed[8],
            "plain_ms": cuda_ms(prod.plain, groups=5, per_group=2),
            "bound_ms": bound_ms, "bound_by": bound_by, "rate": prod.ops / timed[2] / 1e9,
        }
        say(f"{key}: {json.dumps(case)}")
        if not torch.equal(out, ref):
            fail(f"{key} differs from its plain version: max |err| {case['max_abs_err']}")
        if not case["equal_cpu_plain"]:
            fail(f"{key}: the plain version differs between the card and the CPU")
        mm_cases[key] = case
        del out, ref
    # registers, spills and shared memory from the build log, and the
    # wrapper's host time a call (100 enqueues, no synchronize between),
    # which must stay below the kernel's time for the events to time the kernel
    kernel_usage = probe_mm_usage()
    mm_build = {}
    for key, kind in (("P1", "s8"), ("P2", "bf16"), ("P3", "s8")):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(100):
            prods[key].call()
        host_us = (time.perf_counter() - t) / 100 * 1e6
        torch.cuda.synchronize()
        mm_build[key] = {**kernel_usage[kind], "host_us_per_call": host_us}
        say(f"{key}: host {host_us:.1f} us a call against {mm_cases[key]['ms'] * 1e3:.1f} us "
            f"of kernel; {json.dumps(kernel_usage[kind])}")
    lib_s8 = {r["F"]: r["ms"] for r in mm_rows if r["probe"] == "library"}
    xb, wtb = x.to(torch.bfloat16), wt.to(torch.bfloat16)
    lib_bf16_ms = cuda_ms(lambda: torch.mm(xb, wtb.t(), out_dtype=torch.float32))
    say(f"P2 library torch.mm (bf16 in, f32 out): {lib_bf16_ms} ms")
    del x, wt, xb, wtb, prods, small
    entries = [
        probe_entry("probe_int8_mm", "tubedetr_tpu_torch/csrc/probe_mm.cu",
                    "scripts/probe_pallas_int8.py:72", {"F2": mm_cases["P1"]}, "F2", lib_s8[2]),
        probe_entry("probe_bf16_mm", "tubedetr_tpu_torch/csrc/probe_mm.cu",
                    "scripts/probe_pallas_int8.py:101", {"F2": mm_cases["P2"]}, "F2", lib_bf16_ms),
        probe_entry("probe_int8_mm_frames", "tubedetr_tpu_torch/csrc/probe_mm.cu",
                    "scripts/probe_pallas_int8.py:129", {"F2": mm_cases["P3"]}, "F2", lib_s8[2]),
    ]
    entries[0]["library"] = entries[2]["library"] = "torch._int_mm (cuBLASLt)"
    entries[1]["library"] = "torch.mm bf16, out_dtype float32"
    for entry, key in zip(entries, ("P1", "P2", "P3")):
        entry.update(mm_build[key])

    # ---- P4 and P5 at the script's shapes
    n, h, w, c, p = fv.N, fv.H, fv.W, fv.C, fv.P
    flat_usage = k2_usage()  # P5 runs K2's kernel in its flat layout
    bv_cases, flat_cases = {}, {}
    for flat, cases in ((False, bv_cases), (True, flat_cases)):
        x, fold = fv.make_inputs(flat)
        small = {dev: fv.make_inputs(flat, n=2, device=dev) for dev in ("cpu", "cuda")}
        outs = {}
        variants = dict.fromkeys(fv.parse_spec(spec)[0] for spec in PROBE_SPECS)
        for variant in (v for v in variants if (v in pb.FLAT_VARIANTS) == flat):
            torch.full_like(x, 85)  # freed: the output lands on garbage, so a missed pad row shows
            out = fv.variant_call(variant, x, fold)()
            ref = fv.plain_call(variant, x, fold)()
            torch.cuda.synchronize()
            small_plain = {dev: fv.plain_call(variant, *small[dev])() for dev in small}
            kernel = fv.KERNEL[variant]
            # what the kernel reads besides the stream: w1, w3, a1, b1, a3, b3
            # and sid; all but convonly also w2, a2 and b2
            conv2 = kernel != "convonly"
            weights = c * p + p * c + conv2 * 9 * p * p
            vectors = 2 * p + 2 * c + 1 + conv2 * 2 * p
            ops = 2 * n * h * w * weights  # on the h*w real rows
            bound_ms, bound_by = bound(2 * x.numel() + weights + 4 * vectors, ops, INT8_OPS_PER_S)
            row = next(r for r in fv_rows if r["variant"] == variant)
            case = {
                "spec": row["spec"], "kernel": kernel, "same_kernel_as": row["same_kernel_as"],
                "shape": {"N": n, "rows_per_frame": x.shape[1], "H": h, "W": w, "C": c, "P": p},
                "max_abs_err": max_err(out, ref), "tolerance": "exact",
                "equal_cpu_plain": bool(torch.equal(small_plain["cuda"].cpu(), small_plain["cpu"])),
                "ms": row["ms"], "ms_all_specs": {r["spec"]: r["ms"] for r in fv_rows
                                                  if r["variant"] == variant},
                "plain_ms": cuda_ms(fv.plain_call(variant, x, fold), groups=5, per_group=2),
                "bound_ms": bound_ms, "bound_by": bound_by, "ops": ops,
                "tops": ops / row["ms"] / 1e9,
                **({} if not flat else entry_usage(
                    flat_usage[variant][p], tile_plan(w, p, 1, variant == "im2col").smem_bytes)),
            }
            say(f"{variant}: {json.dumps(case)}")
            if not torch.equal(out, ref):
                fail(f"{variant} differs from its plain version: max |err| {case['max_abs_err']}")
            if not case["equal_cpu_plain"]:
                fail(f"{variant}: the plain version differs between the card and the CPU")
            outs[variant] = out
            cases[variant] = case
        if flat:  # dot2d runs full's kernel: nothing to compare there
            if not torch.equal(outs["hwpad"], outs["im2col"]):
                fail("hwpad and im2col compute one function but differ")
            if bool((outs["hwpad"][:, h * w:] != 0).any()):
                fail("P5 wrote a non-zero pad row")
        del x, fold, small, outs

    # ---- noshift and convonly beside K2 at layer3's serving shape
    c, p, h, w, d = PROBE_SERVING
    xq, fold = k2_block(c, p, h, w, d, K2_TIME_FRAMES, seed=PROBE_SERVING_SEED)
    serving = {"shape": {"N": K2_TIME_FRAMES, "H": h, "W": w, "C": c, "P": p}}
    for variant in ("noshift", "convonly"):
        out, ref = pb.bottleneck_variant(xq, fold, variant), pb.bottleneck_variant_plain(xq, fold, variant)
        serving[f"{variant}_max_abs_err"] = max_err(out, ref)
        if not torch.equal(out, ref):
            fail(f"{variant} at layer3's serving shape differs from its plain version")
        del out, ref
    k2_ms = lambda: cuda_ms(lambda: fused_bottleneck_block(xq, fold, d), groups=11, per_group=5)  # noqa: E731
    serving["k2_ms_before"] = k2_ms()
    for variant in ("noshift", "convonly"):
        serving[f"{variant}_ms"] = cuda_ms(lambda: pb.bottleneck_variant(xq, fold, variant),
                                           groups=11, per_group=5)
    serving["k2_ms_after"] = k2_ms()
    say(f"layer3 serving shape: {json.dumps(serving)}")
    bv_cases["serving-layer3"] = {**serving, "max_abs_err": max(
        serving["noshift_max_abs_err"], serving["convonly_max_abs_err"])}
    del xq, fold
    torch.cuda.empty_cache()

    entries.append(probe_entry(
        "probe_bottleneck_variants", "tubedetr_tpu_torch/csrc/fused_bottleneck.cu",
        "scripts/probe_fused_variants.py:129", bv_cases, "full", None))
    entries.append(probe_entry(
        "probe_flat_bottleneck", "tubedetr_tpu_torch/csrc/fused_bottleneck.cu",
        "scripts/probe_fused_variants.py:237", flat_cases, "hwpad", None))
    for entry, key in zip(entries, ("P1", "P2", "P3", "P4", "P5")):
        entry["launches"] = launches[key]
        entry["probe"] = key
    return entries


def full_width_cfg(dtype: str, **extra):
    from tubedetr_tpu_torch.config import TubeDETRConfig

    # bench.py's headline model: ResNet-101, RoBERTa-base (config defaults),
    # hidden 256, 6+6 layers, 8 heads, FFN 2048
    return TubeDETRConfig(**{
        "backbone": "resnet101", "resolution": 352, "video_max_len": 200,
        "video_max_len_train": 200, "stride": 4, "fast": True, "sted": True,
        "guided_attn": False, "aux_loss": False, "dropout": 0.0, "compute_dtype": dtype, **extra,
    })


def check_tubes(label, results):
    import numpy as np

    for r in results:
        s, e = r["sted"]
        if not (0 <= s < e <= K1_SHAPE[0]):
            fail(f"{label}: segment {r['sted']} outside [0, {K1_SHAPE[0]}]")
        b = np.asarray(r["boxes"])
        if b.shape != (K1_SHAPE[0], 4) or not np.isfinite(b).all():
            fail(f"{label}: pixel boxes {b.shape}, finite={np.isfinite(b).all()}")


def check_results(label, results, outputs):
    import numpy as np

    check_tubes(label, results)
    pb = outputs["pred_boxes"]
    if pb.shape != (2, K1_SHAPE[0], 4) or not np.isfinite(pb).all():
        fail(f"{label}: pred_boxes {pb.shape}, finite={np.isfinite(pb).all()}")
    if pb.min() < 0 or pb.max() > 1:
        fail(f"{label}: pred_boxes outside [0, 1]: [{pb.min()}, {pb.max()}]")
    if not np.isfinite(outputs["pred_sted"]).all():
        fail(f"{label}: non-finite pred_sted")


def serve(label: str, cfg, reqs, b1: bool = True):
    """One full-width serving path: build, cold B=2 (calibration apart),
    warm B=2, warm B=1, the prepare / forward / backbone split and peak
    memory. Kernel counts are zeroed just before and read just after.
    Returns (stats, pred_boxes, launches by kernel, backbone passes)."""
    import torch

    from tubedetr_tpu_torch.apps.pipeline import GroundingPipeline
    from tubedetr_tpu_torch.ops.fused_bottleneck import fused_bottleneck_block
    from tubedetr_tpu_torch.ops.resize_normalize import resize_normalize

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resize_normalize.launches = 0
    fused_bottleneck_block.launches = 0
    t0 = time.perf_counter()
    pipe = GroundingPipeline(cfg)
    build_s = time.perf_counter() - t0
    prepared, passes = 0, 0

    _, cold_s = synced(lambda: pipe.ground_many(reqs, render=False))
    prepared, passes = prepared + 2, passes + 1
    stats = {"build_s": build_s, "cold_ground_many_b2_s": cold_s,
             "cold_calibration_s": pipe.calibration_s}
    results, many_s = synced(lambda: pipe.ground_many(reqs, render=False))
    prepared, passes = prepared + 2, passes + 1
    stats.update({"warm_ground_many_b2_s": many_s, "warm_per_request_s_b2": many_s / 2})
    if b1:
        one, one_s = synced(lambda: pipe.ground(*reqs[0], render=False))
        results.append(one)
        prepared, passes = prepared + 1, passes + 1
        stats["warm_ground_b1_s"] = one_s
    stats["max_memory_allocated_gib"] = torch.cuda.max_memory_allocated() / 2**30
    # where a warm B=2 request goes: decode + upload + K1 + pad, the whole
    # forward (collate included), and the backbone alone inside it
    samples, prepare_s = synced(
        lambda: [pipe.prepare(*r, video_id=f"req{i}")[0] for i, r in enumerate(reqs)]
    )
    frames_dtype = samples[0].frames.dtype
    (outputs, batch), forward_s = synced(lambda: pipe.forward(samples))
    with torch.inference_mode():
        _, backbone_s = synced(lambda: pipe.model.encode_frames(
            batch["frames_fast"].flatten(0, 1), batch["fast_pad_mask"].flatten(0, 1)
        ))
    prepared, passes = prepared + 2, passes + 2
    launches = {"resize_normalize": resize_normalize.launches,
                "fused_bottleneck": fused_bottleneck_block.launches}
    del samples, batch
    check_results(label, results, outputs)
    stats.update({
        "b2_prepare_s": prepare_s, "b2_forward_s": forward_s, "b2_backbone_s": backbone_s,
        "frames_dtype": str(frames_dtype).replace("torch.", ""),
        "segments": [r["sted"] for r in results],
        "requests_prepared": prepared, "backbone_passes": passes, "launches": launches,
    })
    print(f"[main] {label}: " + json.dumps(stats), flush=True)
    if launches["resize_normalize"] != prepared:
        fail(f"{label}: K1 launched {launches['resize_normalize']} times for "
             f"{prepared} requests prepared")
    del pipe
    return stats, outputs["pred_boxes"], launches, passes


def phase_main_path(workdir: str):
    """Full-width serving: float bf16 and f32, int8_static with K2, and
    int8_static unfused. Returns the launch counts of the int8 + K2 path."""
    import numpy as np

    rng = np.random.RandomState(0)
    paths = []
    for i in range(2):
        p = os.path.join(workdir, f"request{i}.npy")
        np.save(p, rng.randint(0, 256, K1_SHAPE, dtype=np.uint8))
        paths.append(p)
    reqs = [(paths[0], "a man in a red shirt rides a horse", -1.0, -1.0),
            (paths[1], "the dog runs across the grass", -1.0, -1.0)]

    boxes = {}
    for dtype in ("bfloat16", "float32"):
        _, boxes[dtype], launches, _ = serve(dtype, full_width_cfg(dtype), reqs)
        if launches["fused_bottleneck"]:
            fail(f"{dtype}: the float backbone launched K2")
    print(f"[main] pred_boxes max |bf16 - f32| = "
          f"{float(np.abs(boxes['bfloat16'] - boxes['float32']).max())}", flush=True)

    stats, boxes["int8"], k2_launches, passes = serve(
        "int8_static+fused", full_width_cfg("bfloat16", backbone_quant="int8_static",
                                            fused_bottleneck=True), reqs)
    if stats["frames_dtype"] != "bfloat16":
        fail(f"int8: K1 wrote {stats['frames_dtype']}, not bfloat16")
    if k2_launches["fused_bottleneck"] != K2_PER_PASS * passes:
        fail(f"int8: K2 launched {k2_launches['fused_bottleneck']} times for {passes} "
             f"static backbone passes ({K2_PER_PASS} each)")
    print(f"[main] pred_boxes max |int8 - bf16| = "
          f"{float(np.abs(boxes['int8'] - boxes['bfloat16']).max())}", flush=True)

    _, _, launches, _ = serve(
        "int8_static-unfused", full_width_cfg("bfloat16", backbone_quant="int8_static"),
        reqs, b1=False)
    if launches["fused_bottleneck"]:
        fail("int8 unfused: K2 launched")
    return k2_launches


def small_cfg():
    from tubedetr_tpu_torch.config import TubeDETRConfig

    return TubeDETRConfig(
        backbone="resnet14", hidden_dim=32, nheads=4, enc_layers=1, dec_layers=2,
        dim_feedforward=64, video_max_len=8, video_max_len_train=8, stride=2,
        resolution=128, max_text_len=8, text_vocab_size=128, text_hidden_size=32,
        text_layers=1, text_heads=4, text_ffn=64, text_max_positions=40,
        guided_attn=False, aux_loss=False, dropout=0.0,
    )


def phase_small_agreement(workdir: str):
    """One small request through the pipeline on the card and on the CPU."""
    import numpy as np

    from tubedetr_tpu_torch.apps.pipeline import GroundingPipeline

    path = os.path.join(workdir, "small.npy")
    np.save(path, np.random.RandomState(1).randint(0, 256, (7, 96, 160, 3), dtype=np.uint8))
    outs = {}
    for dev in ("cuda", "cpu"):
        pipe = GroundingPipeline(small_cfg(), device=dev)
        outs[dev] = pipe.forward([pipe.prepare(path, "a red square", -1, -1, "v")[0]])[0]
    for k in ("pred_boxes", "pred_sted", "weights", "ca_weights"):
        d = float(np.abs(outs["cuda"][k] - outs["cpu"][k]).max())
        print(f"[small] {k}: max |card - cpu| = {d} (atol {SMALL_ATOL})", flush=True)
        if not d <= SMALL_ATOL:
            fail(f"small request: {k} differs between card and CPU by {d}")


def phase_small_int8_agreement(workdir: str):
    """The small config with resnet26 (one K2 tail per stage), int8_static +
    fused: calibrated once on the CPU, the same scales copied to the card,
    the same bf16 frames on both; the trunk's output in steps of its scale,
    and the boxes and sted logits against ``SMALL_INT8_ATOL``. Then the
    same model in ``int8_qat`` on those scales and frames, card against
    CPU (``SMALL_QAT_CORR``, ``SMALL_QAT_ATOL``)."""
    import numpy as np
    import torch

    from tubedetr_tpu_torch.apps.pipeline import GroundingPipeline
    from tubedetr_tpu_torch.models.quantize import model_qscales
    from tubedetr_tpu_torch.ops.fused_bottleneck import fused_bottleneck_block

    cfg = small_cfg().replace(backbone="resnet26", backbone_quant="int8_static",
                              fused_bottleneck=True)
    path = os.path.join(workdir, "small.npy")
    cpu = GroundingPipeline(cfg, device="cpu")
    sample, _ = cpu.prepare(path, "a red square", -1, -1, "v")
    outs = {"cpu": cpu.forward([sample])[0]}  # calibrates on the CPU
    card = GroundingPipeline(cfg, device="cuda")
    card.set_qscales(model_qscales(cpu.model))
    frames_cpu = sample.frames
    sample.frames = frames_cpu.cuda()
    before = fused_bottleneck_block.launches
    outs["cuda"] = card.forward([sample])[0]
    if fused_bottleneck_block.launches != before + 4:
        fail("small int8: the card's forward did not run K2 on its 4 tails")
    body_cpu, body_card = cpu.model.backbone[0].body, card.model.backbone[0].body
    with torch.inference_mode():
        feats = {"cpu": body_cpu(frames_cpu.float()).float().numpy(),
                 "cuda": body_card(sample.frames.float()).float().cpu().numpy()}
    step = float(body_cpu.layer4[-1].out_max) / 127.0
    steps = np.abs(feats["cuda"] - feats["cpu"]) / step
    print(f"[small-int8] trunk output |card - cpu|: max {steps.max():.3f} steps "
          f"(at most {SMALL_INT8_STEPS}), {float((steps > 0.5).mean())} of elements differ",
          flush=True)
    if not steps.max() <= SMALL_INT8_STEPS + 1e-3:
        fail(f"small int8 request: the trunk outputs differ by {steps.max()} steps")
    for k, atol in SMALL_INT8_ATOL.items():
        d = float(np.abs(outs["cuda"][k] - outs["cpu"][k]).max())
        print(f"[small-int8] {k}: max |card - cpu| = {d} (atol {atol})", flush=True)
        if not d <= atol:
            fail(f"small int8 request: {k} differs between card and CPU by {d}")

    # the same model trained with fake quantization (int8_qat) on the same
    # scales and frames: float convs on the int8 grid, no K2
    qcfg = cfg.replace(backbone_quant="int8_qat", fused_bottleneck=False)
    scales = model_qscales(cpu.model)
    qat = {}
    for dev, frames in (("cpu", frames_cpu), ("cuda", sample.frames)):
        pipe = GroundingPipeline(qcfg, device=dev)
        pipe.set_qscales(scales)
        sample.frames = frames
        before = fused_bottleneck_block.launches
        out = pipe.forward([sample])[0]
        if fused_bottleneck_block.launches != before:
            fail("small QAT: the QAT model launched K2")
        with torch.inference_mode():
            trunk = pipe.model.backbone[0].body(frames.float()).float().cpu().numpy()
        qat[dev] = (out, trunk)
    corr = float(np.corrcoef(qat["cuda"][1].ravel(), qat["cpu"][1].ravel())[0, 1])
    line = {"trunk_corr": corr, "trunk_max_steps": float(
        np.abs(qat["cuda"][1] - qat["cpu"][1]).max() / step)}
    for k in SMALL_QAT_ATOL:
        line[k] = float(np.abs(qat["cuda"][0][k] - qat["cpu"][0][k]).max())
    print(f"[small-qat] card vs cpu: {json.dumps(line)} (corr above {SMALL_QAT_CORR}, atol "
          f"{SMALL_QAT_ATOL})", flush=True)
    if not corr > SMALL_QAT_CORR:
        fail(f"small QAT request: trunk correlation card vs CPU {corr}")
    for k, atol in SMALL_QAT_ATOL.items():
        if not line[k] <= atol:
            fail(f"small QAT request: {k} differs between card and CPU by {line[k]}")


def http_json(url: str, timeout: float = WAIT_S):
    """(status, parsed JSON or text) of a GET, HTTP errors included."""
    import urllib.error
    import urllib.request

    try:
        resp = urllib.request.urlopen(url, timeout=timeout)
        code, body = resp.status, resp.read()
    except urllib.error.HTTPError as err:
        code, body = err.code, err.read()
    try:
        return code, json.loads(body)
    except ValueError:
        return code, body.decode(errors="replace")


def phase_serve(workdir: str):
    """The port's HTTP ``Server`` at full width on the card: the headline
    int8_static + K2 model, ``serve_max_batch=2``, a 50 ms window, the two
    360p clips of phase 4 under the video root. One cold request
    (calibration inside), two requests at once from two client threads, one
    request alone; then the same requests through ``ground_many`` directly,
    /healthz, /stats, a request outside the root, and drain. Returns the
    launch counts of the HTTP requests (counts zeroed just before the
    server is built, read once its dispatcher is idle)."""
    import threading
    import urllib.parse
    from http.server import ThreadingHTTPServer

    import numpy as np
    import torch

    from tubedetr_tpu_torch.apps.serve import Server, make_handler
    from tubedetr_tpu_torch.ops.fused_bottleneck import fused_bottleneck_block
    from tubedetr_tpu_torch.ops.resize_normalize import resize_normalize

    cfg = full_width_cfg("bfloat16", backbone_quant="int8_static", fused_bottleneck=True).replace(
        serve_max_batch=2, serve_batch_window_ms=50.0, output_dir=os.path.join(workdir, "serve_out"))
    reqs = [("request0.npy", "a man in a red shirt rides a horse"),
            ("request1.npy", "the dog runs across the grass"),
            ("request1.npy", "a child throws a ball")]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resize_normalize.launches = 0
    fused_bottleneck_block.launches = 0
    t0 = time.perf_counter()
    server = Server(cfg, video_root=workdir)  # cfg.device: the card
    build_s = time.perf_counter() - t0
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server))
    listener = threading.Thread(target=httpd.serve_forever, daemon=True)
    listener.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"

    def stvg(video, question):
        q = urllib.parse.urlencode({"video": video, "question": question, "format": "json"})
        return http_json(f"{url}/stvg?{q}")

    def timed(fn):
        t = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t

    # the dispatcher's own seconds a batch, so the HTTP + queue + window
    # share of a request's wall time shows apart from its ground_many
    dispatched = []
    ground_many = server.pipeline.ground_many

    def timed_ground_many(batch, **kw):
        t = time.perf_counter()
        try:
            return ground_many(batch, **kw)
        finally:
            dispatched.append((len(batch), time.perf_counter() - t))

    server.pipeline.ground_many = timed_ground_many
    answers = {}
    try:
        answers["cold"], cold_s = timed(lambda: stvg(*reqs[2]))
        forwards = server.pipeline.forwards
        start = threading.Barrier(3)

        def client(i):
            start.wait()
            answers[i] = stvg(*reqs[i])

        clients = [threading.Thread(target=client, args=(i,)) for i in range(2)]
        for th in clients:
            th.start()
        start.wait()
        t = time.perf_counter()
        for th in clients:
            th.join(timeout=WAIT_S)
        pair_s = time.perf_counter() - t
        pair_forwards = server.pipeline.forwards - forwards
        answers["lone"], lone_s = timed(lambda: stvg(*reqs[2]))
        for key, (code, body) in answers.items():
            if code != 200:
                fail(f"serve: request {key} answered {code}: {body}")
        launches = {"resize_normalize": resize_normalize.launches,
                    "fused_bottleneck": fused_bottleneck_block.launches}
        n_forwards = server.pipeline.forwards

        # the same requests through ground_many directly, as the dispatcher
        # calls it (rendering into the output dir included)
        pipe = server.pipeline
        pipe.ground_many = ground_many
        direct = lambda rs, tag: pipe.ground_many(  # noqa: E731
            [(os.path.join(workdir, v), q, -1.0, -1.0) for v, q in rs],
            out_dir=server.out_dir, tags=[f"-direct{tag}{i}" for i in range(len(rs))])
        pair_direct, pair_direct_s = synced(lambda: direct(reqs[:2], "p"))
        (lone_direct,), lone_direct_s = synced(lambda: direct(reqs[2:], "l"))
        size = np.array([K1_SHAPE[2], K1_SHAPE[1]] * 2, np.float64)
        max_box_err = 0.0
        for key, ref in ((0, pair_direct[0]), (1, pair_direct[1]), ("lone", lone_direct),
                         ("cold", lone_direct)):
            got = answers[key][1]
            if got["sted"] != ref["sted"]:
                fail(f"serve: request {key} segment {got['sted']} is not ground_many's {ref['sted']}")
            err = float(np.abs(np.asarray(got["boxes"]) / size - np.asarray(ref["boxes"]) / size).max())
            max_box_err = max(max_box_err, err)
            if not err <= 1e-4:
                fail(f"serve: request {key} boxes differ from ground_many's by {err}")
        check_tubes("serve", [pair_direct[0], pair_direct[1], lone_direct])

        health, stats = http_json(f"{url}/healthz"), http_json(f"{url}/stats")
        outside = stvg("../request0.npy", "outside the root")
        drained = server.drain(timeout=60)
        after_health = http_json(f"{url}/healthz")
        after_stvg = stvg(*reqs[2])
    finally:
        httpd.shutdown()
        httpd.server_close()
        listener.join(timeout=30)
    out = {
        "build_s": build_s,
        "cold_http_s": cold_s, "cold_calibration_s": pipe.calibration_s,
        "warm_http_pair_s": pair_s, "warm_ground_many_pair_s": pair_direct_s,
        "warm_http_lone_s": lone_s, "warm_ground_many_lone_s": lone_direct_s,
        "dispatched_batches_s": [[n, sec] for n, sec in dispatched],
        "http_queue_window_pair_s": pair_s - dispatched[1][1],
        "http_queue_window_lone_s": lone_s - dispatched[2][1],
        "pair_forwards": pair_forwards, "forwards": n_forwards, "launches": launches,
        "max_box_err_vs_ground_many": max_box_err,
        "segments": [answers[k][1]["sted"] for k in ("cold", 0, 1, "lone")],
        "healthz": health[0], "stats": {k: stats[1][k] for k in ("requests_ok", "requests_failed")},
        "outside_root": outside[0], "drained": drained,
        "after_drain": {"healthz": list(after_health), "stvg": after_stvg[0]},
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    print(f"[serve] {json.dumps(out)}", flush=True)
    if pair_forwards != 1 or [n for n, _ in dispatched] != [1, 2, 1]:
        fail(f"serve: the two concurrent requests ran as {pair_forwards} forwards, not one "
             f"(batches {[n for n, _ in dispatched]})")
    if n_forwards != 3 or launches["resize_normalize"] != 4:
        fail(f"serve: {n_forwards} forwards and {launches['resize_normalize']} K1 launches "
             "for 4 requests in 3 batches")
    if launches["fused_bottleneck"] != K2_PER_PASS * n_forwards:
        fail(f"serve: K2 launched {launches['fused_bottleneck']} times for {n_forwards} "
             f"backbone passes ({K2_PER_PASS} each)")
    if health[0] != 200 or stats[1]["requests_ok"] != 4 or stats[1]["requests_failed"] != 0:
        fail(f"serve: /healthz {health[0]}, /stats {out['stats']}")
    if outside[0] != 403:
        fail(f"serve: a video outside the root answered {outside[0]}, not 403")
    if not drained or after_health != (503, {"status": "draining"}) or after_stvg[0] != 503:
        fail(f"serve: after drain() /healthz {after_health}, /stvg {after_stvg[0]}")
    return launches


def fan_in_state_dict(model, seed: int):
    """Weights from a numpy seed at the scale of a trained model's: each
    matrix, conv kernel and embedding ``N(0, 1/fan_in)``, vectors (norms,
    biases, FrozenBN statistics) as ``fabricate_state_dict`` leaves them.
    At the seed weights' 0.02 the heads' logits sit within 1e-6 of each
    other and an argmax between queries would read summation order."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    out = {}
    for name, t in model.state_dict().items():
        if t.dim() >= 2:
            v = rng.randn(*t.shape) / np.sqrt(t[0].numel())
            t = torch.from_numpy(v.astype(np.float32))
        out[name] = t.float().cpu()
    return out


VARIANTS = {"gating": dict(fast_mode="gating"), "transformer": dict(fast_mode="transformer"),
            "pool": dict(fast_mode="pool"), "noslow": dict(fast_mode="noslow"),
            "nq3": dict(num_queries=3),
            # the model flags and the GroupNorm trunk
            "learned": dict(position_embedding="learned"), "v2": dict(position_embedding="v2"),
            "v3": dict(position_embedding="v3"), "no_tsa": dict(no_tsa=True),
            "learn_time_embed": dict(learn_time_embed=True),
            "no_time_embed": dict(no_time_embed=True), "gn": dict(backbone="resnet14-gn")}
# the model flags served at full width, int8_static + K2
FLAG_SERVING = {"learned+learn_time_embed": dict(position_embedding="learned", learn_time_embed=True),
                "no_tsa+no_time_embed": dict(no_tsa=True, no_time_embed=True)}


def phase_variants(workdir: str):
    """The other inference configurations. On the small config, card against
    CPU with the same seeded weights (``fan_in_state_dict``) and the same
    frames (prepared on the CPU), every output to ``SMALL_ATOL``; for ``num_queries=3`` the two
    selectors' winners equal too. The tubes of card and CPU, scored by
    ``VIoUEvaluator`` against seeded annotations, summarize within 1e-3.
    The variants include the model flags (``learned``, ``v2``, ``v3``,
    ``no_tsa``, ``learn_time_embed``, ``no_time_embed``) and the GroupNorm
    trunk (``resnet14-gn``). Then ``fast_mode="transformer"`` at full width
    in bf16: one warm B=2 ``ground_many``. Then each of ``FLAG_SERVING`` at
    full width in int8_static + K2: a cold and a warm B=2 ``ground_many``,
    K1 once a request and held to its plain version on the request's
    frames, K2 ``K2_PER_PASS`` times a backbone pass and exact against its
    plain version on the inputs it got. Then the ``resnet101-gn`` trunk at
    full width in bf16: one training step of the published config and one
    B=2 serving call. Returns the launches of K1 and K2 on the flag legs."""
    import numpy as np
    import torch

    from tubedetr_tpu_torch.apps.pipeline import GroundingPipeline
    from tubedetr_tpu_torch.data.annotations import VideoAnnotation
    from tubedetr_tpu_torch.eval.viou import VIoUEvaluator
    from tubedetr_tpu_torch.models.postprocess import (
        postprocess_boxes,
        postprocess_sted,
        select_query_by_objectness,
        select_query_by_sted,
    )

    path = os.path.join(workdir, "small.npy")
    rng = np.random.RandomState(4)
    evaluators = {dev: [] for dev in ("cuda", "cpu")}
    anns = []
    for name, extra in VARIANTS.items():
        cfg = small_cfg().replace(**extra)
        pipes = {dev: GroundingPipeline(cfg, device=dev) for dev in ("cuda", "cpu")}
        weights = fan_in_state_dict(pipes["cpu"].model, seed=len(anns))
        for pipe in pipes.values():
            pipe.model.load_state_dict(weights)
        sample, ctx = pipes["cpu"].prepare(path, "a red square", -1, -1, name)
        outs, batch = pipes["cpu"].forward([sample])
        sample.frames = sample.frames.cuda()
        outs = {"cpu": outs, "cuda": pipes["cuda"].forward([sample])[0]}
        errs = {k: float(np.abs(outs["cuda"][k] - outs["cpu"][k]).max()) for k in outs["cpu"]}
        worst = max(errs, key=errs.get)
        line = {"keys": len(errs), "max_abs_err": errs[worst], "worst": worst}
        if set(outs["cuda"]) != set(outs["cpu"]) or not errs[worst] <= SMALL_ATOL:
            fail(f"variant {name}: {worst} differs between card and CPU by {errs[worst]}")
        t, h, w = ctx["t"], ctx["h"], ctx["w"]
        mask = batch["time_mask"]
        if cfg.num_queries > 1:
            sel = {dev: (select_query_by_sted(o["pred_sted_queries"], mask, [name]).tolist(),
                         select_query_by_objectness(o["pred_obj_queries"], mask).tolist())
                   for dev, o in outs.items()}
            obj = np.sort(outs["cpu"]["pred_obj_queries"][0, :t], axis=-1)
            line.update(selected=sel["cuda"], objectness_min_gap=float((obj[:, -1] - obj[:, -2]).min()))
            if sel["cuda"] != sel["cpu"]:
                fail(f"variant {name}: the query selectors pick {sel['cuda']} on the card, "
                     f"{sel['cpu']} on the CPU")
        # a seeded annotation for this request, and each device's tube
        t0 = int(rng.randint(0, t - 2))
        t1 = int(rng.randint(t0 + 1, t + 1))
        inter = list(range(t0, t1))
        anns.append(VideoAnnotation(
            video_id=name, frame_ids=list(range(t)), inter_frames=inter, tube_start_frame=t0,
            tube_end_frame=t1, caption="a red square", qtype=("declarative", "interrogative")[len(anns) % 2],
            boxes_xywh={f: [float(v) for v in rng.uniform(10, 60, 4)] for f in inter},
            video_path=path, start_seconds=0.0, duration_seconds=t / 5))
        for dev, o in outs.items():
            (sted,) = postprocess_sted(o["pred_sted"], [list(range(t))], [name], mask)
            boxes = postprocess_boxes(o["pred_boxes"][0], np.array([h, w]))[:t]
            evaluators[dev].append(({f"{name}_{f}": {"boxes": [boxes[f].tolist()]} for f in range(t)},
                                    {name: {"sted": [int(sted[0]), int(sted[1])]}}))
            line[f"sted_{dev}"] = [int(sted[0]), int(sted[1])]
        print(f"[variants] {name}: {json.dumps(line)}", flush=True)
        del pipes
    summaries = {}
    for dev, items in evaluators.items():
        ev = VIoUEvaluator(anns)
        for frames, video in items:
            ev.update(frames)
            ev.video_update(video)
        summaries[dev] = ev.summarize()
    diff = max(abs(summaries["cuda"][k] - summaries["cpu"][k]) for k in summaries["cpu"])
    print(f"[variants] vIoU card {json.dumps(summaries['cuda'])}; max |card - cpu| {diff}",
          flush=True)
    if set(summaries["cuda"]) != set(summaries["cpu"]) or not diff <= 1e-3:
        fail(f"variants: the vIoU summaries of card and CPU differ by {diff}")

    # fast_mode="transformer" at full width: 2 x 836 sequences of 200 frames.
    # Its forward is timed in turns with the default fast branch's on the
    # same prepared frames (default, transformer, transformer, default, ...)
    reqs = [(os.path.join(workdir, f"request{i}.npy"), q, -1.0, -1.0)
            for i, q in enumerate(("a man in a red shirt rides a horse",
                                   "the dog runs across the grass"))]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pipe = GroundingPipeline(full_width_cfg("bfloat16", fast_mode="transformer"))
    _, cold_s = synced(lambda: pipe.ground_many(reqs, render=False))
    results, warm_s = synced(lambda: pipe.ground_many(reqs, render=False))
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_tubes("transformer full width", results)
    pipes = {"default": GroundingPipeline(full_width_cfg("bfloat16")), "transformer": pipe}
    samples = [pipe.prepare(*r, video_id=f"req{i}")[0] for i, r in enumerate(reqs)]
    forward_s = {name: [] for name in pipes}
    for name in ("default", "transformer", "transformer", "default") * 3:
        (outputs, _), sec = synced(lambda: pipes[name].forward(samples))
        forward_s[name].append(sec)
        if name == "transformer":
            check_results("transformer full width", results, outputs)
    line = {"cold_ground_many_b2_s": cold_s, "warm_ground_many_b2_s": warm_s,
            "b2_forward_s_in_turns": forward_s,
            "b2_forward_median_s": {k: sorted(v)[len(v) // 2] for k, v in forward_s.items()},
            "segments": [r["sted"] for r in results], "max_memory_allocated_gib": peak}
    print(f"[variants] transformer full width bf16: {json.dumps(line)}", flush=True)
    del pipe, pipes, samples, outputs
    torch.cuda.empty_cache()

    from tubedetr_tpu_torch.ops.fused_bottleneck import fused_bottleneck_block
    from tubedetr_tpu_torch.ops.resize_normalize import resize_normalize

    flag_launches = {"resize_normalize": 0, "fused_bottleneck": 0}
    for name, extra in FLAG_SERVING.items():
        cfg = full_width_cfg("bfloat16", backbone_quant="int8_static", fused_bottleneck=True,
                             **extra)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        resize_normalize.launches = 0
        fused_bottleneck_block.launches = 0
        with K1Capture() as k1, K2Capture() as k2:
            pipe = GroundingPipeline(cfg)
            _, cold_s = synced(lambda: pipe.ground_many(reqs, render=False))
            results, warm_s = synced(lambda: pipe.ground_many(reqs, render=False))
        launches = {"resize_normalize": resize_normalize.launches,
                    "fused_bottleneck": fused_bottleneck_block.launches}
        peak = torch.cuda.max_memory_allocated() / 2**30
        check_tubes(name, results)
        if launches["resize_normalize"] != 2 * len(reqs):
            fail(f"{name}: K1 launched {launches['resize_normalize']} times for "
                 f"{2 * len(reqs)} requests")
        if launches["fused_bottleneck"] != 2 * K2_PER_PASS:
            fail(f"{name}: K2 launched {launches['fused_bottleneck']} times for 2 static "
                 f"backbone passes ({K2_PER_PASS} each)")
        for k in flag_launches:
            flag_launches[k] += launches[k]
        line = {"cold_ground_many_b2_s": cold_s, "cold_calibration_s": pipe.calibration_s,
                "warm_ground_many_b2_s": warm_s, "max_memory_allocated_gib": peak,
                "segments": [r["sted"] for r in results], "launches": launches,
                "k1_max_abs_err": k1.check(name), "k2_max_abs_err": k2.check()}
        print(f"[variants] {name} int8_static+fused full width: {json.dumps(line)}", flush=True)
        del pipe, results
    torch.cuda.empty_cache()
    phase_gn_full_width(reqs)
    return flag_launches


def phase_gn_full_width(reqs):
    """The ``resnet101-gn`` trunk at full width in bf16: one training step of
    the published config (dropout on, every loss term finite, the stem's
    and layer1's GroupNorm unchanged, layer2's moved) and one cold B=2
    serving call (tubes in range)."""
    import math

    import torch

    from tubedetr_tpu_torch.apps.pipeline import GroundingPipeline
    from tubedetr_tpu_torch.data.collate import collate_pairs
    from tubedetr_tpu_torch.data.synthetic import make_synthetic_sample
    from tubedetr_tpu_torch.models.tubedetr import build_model
    from tubedetr_tpu_torch.parallel.train_step import create_train_state
    from tubedetr_tpu_torch.train.optim import base_lrs

    cfg = train_cfg().replace(backbone="resnet101-gn", compute_dtype="bfloat16")
    h, w = TRAIN_HW
    sample = make_synthetic_sample(100, t=TRAIN_T, h=h, w=w, vocab=cfg.text_vocab_size, text_len=12)
    ((batch, _),) = collate_pairs([sample], 1, cfg.video_max_len_train, cfg.stride,
                                  cfg.max_text_len)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    model.load_state_dict(fan_in_state_dict(model, seed=8))
    state = create_train_state(cfg, model)
    norms = ("backbone.0.body.bn1.weight", "backbone.0.body.layer1.0.bn1.weight",
             "backbone.0.body.layer2.0.bn1.weight")
    before = {n: model.get_parameter(n).detach().clone() for n in norms}
    step = timed_step(cfg)
    state, _ = step(state, batch, base_lrs(cfg), cfg.seed)
    train_peak = torch.cuda.max_memory_allocated() / 2**30
    bad = [k for k, v in step.metrics[0].items() if not math.isfinite(v)]
    if bad:
        fail(f"gn train: non-finite {bad}")
    moved = {n: not torch.equal(before[n], model.get_parameter(n).detach()) for n in norms}
    if moved[norms[0]] or moved[norms[1]] or not moved[norms[2]]:
        fail(f"gn train: the GroupNorm parameters that moved are {moved}")
    line = {"train_cold_step_s": step.split[0]["step_s"], "train_split_s": step.split[0],
            "train_loss_total": step.metrics[0]["loss_total"],
            "train_peak_memory_gib": train_peak}
    del state, model, step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pipe = GroundingPipeline(full_width_cfg("bfloat16", backbone="resnet101-gn"))
    results, serve_s = synced(lambda: pipe.ground_many(reqs, render=False))
    check_tubes("gn serve", results)
    line.update(serve_cold_ground_many_b2_s=serve_s,
                serve_peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
                segments=[r["sted"] for r in results])
    print(f"[variants] resnet101-gn bf16 full width: {json.dumps(line)}", flush=True)
    del pipe
    torch.cuda.empty_cache()


def train_cfg():
    """The published training config (the JAX ``config.py`` defaults): ResNet-101, RoBERTa-base,
    hidden 256, 6 + 6 layers, 8 heads, FFN 2048, fast branch, sted, aux and guided attention,
    resolution 224, 200 frames at stride 5, B=1, AdamW with ``linear_with_warmup``, EMA on."""
    from tubedetr_tpu_torch.config import TubeDETRConfig

    return TubeDETRConfig(ema=True).validate_training()


def timed_step(cfg, deterministic: bool = False, keep_grads: bool = False):
    """A ``TrainStep`` that times its forward + loss, backward and clip +
    optimizer + EMA between synchronizes (``split``, a step each), and
    records the LRs and metrics of each step and, with ``keep_grads``, the
    last step's pre-clip gradients."""
    from tubedetr_tpu_torch.parallel.train_step import TrainStep

    class TimedStep(TrainStep):
        def __init__(self):
            super().__init__(cfg, deterministic)
            self.lrs, self.split, self.metrics, self.grads = [], [], [], None

        def forward_loss(self, *args, **kwargs):
            out, sec = synced(lambda: super(TimedStep, self).forward_loss(*args, **kwargs))
            self.split[-1]["forward_loss_s"] += sec
            return out

        def backward(self, total):
            _, sec = synced(lambda: super(TimedStep, self).backward(total))
            self.split[-1]["backward_s"] += sec

        def update(self, state, lrs):
            if keep_grads:
                self.grads = {n: p.grad.detach().cpu().clone()
                              for n, p in state.model.named_parameters() if p.grad is not None}
            out, sec = synced(lambda: super(TimedStep, self).update(state, lrs))
            self.split[-1]["clip_opt_ema_s"] += sec
            return out

        def __call__(self, state, batch, lrs, seed):
            self.lrs.append(dict(lrs))
            self.split.append({"forward_loss_s": 0.0, "backward_s": 0.0, "clip_opt_ema_s": 0.0})
            (state, metrics), sec = synced(lambda: super(TimedStep, self).__call__(state, batch, lrs, seed))
            self.split[-1]["step_s"] = sec
            self.metrics.append({k: float(v) for k, v in metrics.items()})
            return state, metrics

    return TimedStep()


def adamw_atol(model, labels, grads, ref_grads, lrs, grad_norm, max_norm):
    """Per-element atol of two post-step parameter sets: ``TRAIN_PARAM_ATOL``
    plus ``lr * |u(g) - u(g_ref)|`` of the clipped gradients, with ``u(g) = g /
    (|g| + 1e-8)`` AdamW's first-step direction; a leaf whose gradient is
    numerically zero (max |g| < 1e-6) may step by up to lr."""
    import torch

    from tubedetr_tpu_torch.train.optim import GROUP_LR

    scale = min(1.0, max_norm / grad_norm)
    atol = {}
    for n, p in model.named_parameters():
        t = torch.full(p.shape, TRAIN_PARAM_ATOL)
        if n in grads:
            lr = lrs[GROUP_LR[labels[n]]]
            if ref_grads[n].abs().max() < 1e-6:
                t += lr
            else:
                g1, g2 = grads[n] * scale, ref_grads[n] * scale
                t += lr * (g1 / (g1.abs() + 1e-8) - g2 / (g2.abs() + 1e-8)).abs()
        atol[n] = t
    return atol


def phase_train_small():
    """The small config, card against CPU: one dropout-free train step (B=2,
    ragged durations 8 and 7, fast branch, ``grad_accum=2``, AdamW, EMA) from
    the same fan-in weights and batch; the loss terms and grad norm within
    ``TRAIN_LOSS_RTOL``, the post-step parameters within ``adamw_atol``. Then
    ``evaluate`` with the EMA parameters over a synthetic val set of three
    16-frame videos cut into 8-frame clips (``div_vid``): the vIoU summaries
    within 1e-3."""
    import numpy as np
    import torch

    from tubedetr_tpu_torch.data.collate import collate_pairs
    from tubedetr_tpu_torch.data.synthetic import SyntheticDataset, make_synthetic_sample
    from tubedetr_tpu_torch.eval.viou import VIoUEvaluator
    from tubedetr_tpu_torch.models.tubedetr import build_model
    from tubedetr_tpu_torch.parallel.train_step import create_train_state, make_eval_step
    from tubedetr_tpu_torch.train.engine import evaluate

    cfg = small_cfg().replace(guided_attn=True, aux_loss=True, batch_size=2, grad_accum=2, ema=True,
                              ema_decay=0.9, lr=1e-3, lr_backbone=1e-4, text_encoder_lr=1e-3)
    lrs = {"lr": cfg.lr, "lr_backbone": cfg.lr_backbone, "lr_text_encoder": cfg.text_encoder_lr}
    weights = fan_in_state_dict(build_model(cfg, device="cpu"), seed=7)
    samples = [make_synthetic_sample(i, t=8 - i, vocab=cfg.text_vocab_size) for i in range(2)]
    ((batch, _),) = collate_pairs(samples, 2, 8, cfg.stride, cfg.max_text_len)
    val = SyntheticDataset(n=3, t=16, seed=20, vocab=cfg.text_vocab_size, text_len=6)
    pairs = collate_pairs(val.samples, 2, 8, cfg.stride, cfg.max_text_len, div_vid=8)
    res = []
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, device=dev)
        model.load_state_dict(weights)
        state = create_train_state(cfg, model)
        step = timed_step(cfg, deterministic=True, keep_grads=True)
        state, metrics = step(state, {k: v.to(dev) if torch.is_tensor(v) else v
                                      for k, v in batch.items()}, lrs, cfg.seed)
        ev = VIoUEvaluator(val.annotations)
        evaluate(cfg, make_eval_step(cfg, ema=True), state, pairs, ev)
        res.append((state, step.metrics[0], step.grads, ev.summarize()))
    (s_card, m_card, g_card, v_card), (s_cpu, m_cpu, g_cpu, v_cpu) = res
    loss_err = max(abs(m_card[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-12) for k in m_cpu)
    atol = adamw_atol(s_cpu.model, s_cpu.labels, g_card, g_cpu, lrs, m_cpu["grad_norm"],
                      cfg.clip_max_norm)
    p_card = {n: p.detach().cpu() for n, p in s_card.model.named_parameters()}
    over = {n: float(((p_card[n] - p.detach()).abs() - atol[n]).max())
            for n, p in s_cpu.model.named_parameters()}
    worst = max(over, key=over.get)
    viou = max(abs(v_card[k] - v_cpu[k]) for k in v_cpu)
    line = {"loss_total_card": m_card["loss_total"], "loss_total_cpu": m_cpu["loss_total"],
            "max_rel_err_losses_and_grad_norm": loss_err, "grad_norm_card": m_card["grad_norm"],
            "params_worst_margin": over[worst], "params_worst": worst,
            "viou_max_abs_diff": viou, "viou_card": v_card}
    print(f"[train-small] {json.dumps(line)}", flush=True)
    if set(m_card) != set(m_cpu) or not loss_err <= TRAIN_LOSS_RTOL:
        fail(f"train small: losses or grad norm differ card vs CPU by {loss_err} (relative)")
    if not over[worst] <= 0:
        fail(f"train small: {worst} differs card vs CPU after the step by {over[worst]} over its atol")
    if set(v_card) != set(v_cpu) or not viou <= 1e-3:
        fail(f"train small: the vIoU summaries of card and CPU differ by {viou}")


def train_trunk_passes(model, batch, cfg):
    """Seconds of the trunk's two training passes over one batch, alone:
    the slow pass (forward with gradients kept, its frozen prefix in
    ``backbone_quant_frozen``, then its backward from a unit gradient) and
    the fast pass without gradients (the k-1 of every k frames the slow
    pass did not cover, in ``backbone_quant_fast``)."""
    import torch

    from tubedetr_tpu_torch.parallel.train_step import model_inputs, to_device

    inputs = model_inputs(to_device(batch, next(model.parameters()).device))
    slow = inputs["frames_slow"].flatten(0, 1)
    feats, fwd_s = synced(lambda: model.backbone_feats(slow, **model.pass_modes(False)))
    _, bwd_s = synced(lambda: feats.backward(torch.ones_like(feats)))
    model.zero_grad(set_to_none=True)
    with torch.no_grad():
        _, fast_s = synced(lambda: model._fast_feats(inputs["frames_fast"], feats.detach(),
                                                     slow.shape[0] // inputs["frames_fast"].shape[0]))
    return {"slow_forward_s": fwd_s, "slow_backward_s": bwd_s, "fast_no_grad_s": fast_s,
            "slow_frames": slow.shape[0], "fast_frames_run": slow.shape[0] * (max(cfg.stride, 1) - 1)}


def device_profile(prof, wall_s: float, top: int = 12) -> dict:
    """A device-activities ``torch.profiler`` trace read against the host
    wall time of what it traced: the sum of the times of the kernels and
    copies (the device's busy share, one stream; the trace's overhead counts
    in the wall time), and the ``top`` of them by time."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        # a record_function range (the optimizer's step) also shows on the
        # device's timeline, over kernels already counted
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        rows.append((us, e.key, e.count))
    rows.sort(reverse=True)
    device_s = sum(r[0] for r in rows) / 1e6
    return {
        "step_s_traced": wall_s, "device_kernel_s": device_s,
        "device_busy_share": device_s / wall_s if wall_s else None,
        "top_kernels": [{"name": k[:90], "s": us / 1e6, "calls": n} for us, k, n in rows[:top]],
    }


def traced_step(cfg, state, batch, lrs, top: int = 12):
    """One warm train step under ``torch.profiler``, device activities only
    (a host trace of the step's ~10^4 ops costs tens of seconds to
    aggregate), read by ``device_profile``."""
    from torch.profiler import ProfilerActivity, profile

    step = timed_step(cfg)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batch, lrs, cfg.seed)
    return state, device_profile(prof, step.split[0]["step_s"], top)


def phase_train(smi: str):
    """Full-width training on the card: ``train_one_epoch`` over
    ``TRAIN_STEPS`` synthetic 200-frame 224x398 videos at the published
    config (dropout on, AdamW, EMA, remat on), then one more step with remat
    off for its peak memory. Checks: every loss term finite and the keys
    ``loss_weight_dict``'s; the stem, layer1 and every FrozenBN buffer
    unchanged bit for bit, layer2-4, the transformer and the text encoder
    changed; the LRs of steps 0-5 ``current_lrs``'s sequence; K1 and K2
    never launched. Returns the launches of K1 and K2 on this path."""
    import math

    import numpy as np
    import torch

    from tubedetr_tpu_torch.config import loss_weight_dict
    from tubedetr_tpu_torch.data.collate import collate_pairs
    from tubedetr_tpu_torch.data.synthetic import make_synthetic_sample
    from tubedetr_tpu_torch.models.resnet import FrozenBatchNorm2d
    from tubedetr_tpu_torch.models.tubedetr import build_model
    from tubedetr_tpu_torch.ops.fused_bottleneck import fused_bottleneck_block
    from tubedetr_tpu_torch.ops.resize_normalize import resize_normalize
    from tubedetr_tpu_torch.parallel.train_step import create_train_state
    from tubedetr_tpu_torch.train.engine import train_one_epoch
    from tubedetr_tpu_torch.train.optim import base_lrs, current_lrs

    cfg = train_cfg()
    h, w = TRAIN_HW
    phase_t0 = t0 = time.perf_counter()
    samples = [make_synthetic_sample(100 + i, t=TRAIN_T, h=h, w=w, vocab=cfg.text_vocab_size,
                                     text_len=12) for i in range(TRAIN_STEPS + 1)]
    pairs = collate_pairs(samples, 1, cfg.video_max_len_train, cfg.stride, cfg.max_text_len)
    data_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg)
    model.load_state_dict(fan_in_state_dict(model, seed=8))
    state = create_train_state(cfg, model)
    build_s = time.perf_counter() - t0
    before = {n: t.detach().clone() for n, t in model.state_dict().items()}
    n_params = sum(p.numel() for p in model.parameters())
    n_trainable = sum(p.numel() for p in model.parameters() if p.requires_grad)

    resize_normalize.launches = 0
    fused_bottleneck_block.launches = 0
    step = timed_step(cfg)
    num_training_steps = cfg.epochs * TRAIN_STEPS
    state, _ = train_one_epoch(cfg, step, state, pairs[:TRAIN_STEPS], 0, num_training_steps)
    metrics_seen = step.metrics
    peak_remat = torch.cuda.max_memory_allocated() / 2**30
    launches = {"resize_normalize": resize_normalize.launches,
                "fused_bottleneck": fused_bottleneck_block.launches}

    # checks
    want_keys = set(loss_weight_dict(cfg)) | {"loss_total", "grad_norm"}
    for i, m in enumerate(metrics_seen):
        if set(m) != want_keys:
            fail(f"train: step {i} losses {sorted(set(m) ^ want_keys)} differ from loss_weight_dict")
        bad = [k for k, v in m.items() if not math.isfinite(v)]
        if bad:
            fail(f"train: step {i} non-finite {bad}")
    want_lrs = [base_lrs(cfg)] + [current_lrs(cfg, 0, i - 1, num_training_steps)
                                  for i in range(1, TRAIN_STEPS)]
    if step.lrs != want_lrs:
        fail(f"train: LRs {step.lrs} are not current_lrs's {want_lrs}")
    after = model.state_dict()
    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    if not frozen or any(not n.startswith(("backbone.0.body.conv1.", "backbone.0.body.layer1."))
                         for n in frozen):
        fail(f"train: the frozen parameters are not the stem and layer1: {frozen[:5]}")
    frozen += [f"{m}.{b}" for m, mod in model.named_modules() if isinstance(mod, FrozenBatchNorm2d)
               for b, _ in mod.named_buffers()]
    moved = [n for n in frozen if not torch.equal(before[n], after[n])]
    if moved:
        fail(f"train: frozen tensors changed: {moved[:5]}")
    for prefix in ("backbone.0.body.layer2.", "backbone.0.body.layer3.", "backbone.0.body.layer4.",
                   "transformer.encoder.", "transformer.decoder.", "transformer.text_encoder.",
                   "bbox_embed.", "sted_embed."):
        names = [n for n, p in model.named_parameters() if n.startswith(prefix)]
        if not names or all(torch.equal(before[n], after[n]) for n in names):
            fail(f"train: no parameter under {prefix} changed")
    if launches["resize_normalize"] or launches["fused_bottleneck"]:
        fail(f"train: the training path launched K1 or K2: {launches}")

    # where a warm step goes: the trunk's passes alone, then one step traced
    extra_batch = pairs[TRAIN_STEPS][0]
    passes = train_trunk_passes(model, extra_batch, cfg)
    lrs_next = current_lrs(cfg, 0, TRAIN_STEPS - 1, num_training_steps)
    state, profile = traced_step(cfg, state, extra_batch, lrs_next)

    # one more step with remat off: its peak memory
    model.backbone[0].body.remat = False
    torch.cuda.reset_peak_memory_stats()
    off = timed_step(cfg)
    state, _ = off(state, extra_batch, lrs_next, cfg.seed)
    peak_no_remat = torch.cuda.max_memory_allocated() / 2**30
    if not math.isfinite(off.metrics[0]["loss_total"]):
        fail("train: non-finite loss with remat off")

    warm = [s["step_s"] for s in step.split[1:]]
    split = {k: float(np.median([s[k] for s in step.split[1:]]))
             for k in ("forward_loss_s", "backward_s", "clip_opt_ema_s")}
    line = {
        "card": smi, "steps": len(step.split), "cold_step_s": step.split[0]["step_s"],
        "warm_step_median_s": float(np.median(warm)), "warm_step_min_s": min(warm),
        "warm_step_max_s": max(warm), "warm_split_median_s": split,
        "warm_steps_s": warm, "peak_memory_gib_remat_on": peak_remat,
        "peak_memory_gib_remat_off": peak_no_remat, "step_s_remat_off": off.split[0]["step_s"],
        "grad_norm_pre_clip": [m["grad_norm"] for m in metrics_seen],
        "loss_total": [m["loss_total"] for m in metrics_seen],
        "params": n_params, "trainable_params": n_trainable, "build_s": build_s, "data_s": data_s,
        "launches": launches, "trunk_passes_s": passes,
        "phase_s": time.perf_counter() - phase_t0,
    }
    print(f"[train] {json.dumps(line)}", flush=True)
    print(f"[train-profile] {json.dumps(profile)}", flush=True)
    del state, model, step, off, pairs, samples
    torch.cuda.empty_cache()
    return launches, line


def deterministic_loss(cfg, model, batch) -> dict:
    """The loss terms of one dropout-free forward of ``model`` on ``batch``,
    the training passes, no gradient."""
    import torch

    from tubedetr_tpu_torch.parallel.train_step import TrainState, make_train_step, to_device

    model.eval()
    with torch.no_grad():
        total, losses = make_train_step(cfg, deterministic=True).forward_loss(
            TrainState(model, None, {}), to_device(batch, torch.device("cuda")))
    out = {k: float(v) for k, v in losses.items()}
    out["loss_total"] = float(total)
    return out


def phase_train_bf16(smi: str, f32: dict):
    """``phase_train`` in bfloat16 compute (``compute_dtype="bfloat16"``,
    float32 parameters and state): ``train_one_epoch`` over the same
    ``TRAIN_STEPS`` videos from the same fan-in weights. Checks: every loss
    term finite; the parameters, the last step's gradients (left on the
    parameters), the AdamW moments and the EMA float32; a forward hook sees bfloat16 out of
    ``input_proj`` and out of the first decoder layer; the stem, layer1 and
    every FrozenBN buffer unchanged bit for bit; K1 and K2 never launched.
    The ``[train-bf16]`` line puts the split, the trunk's passes and the
    peak beside ``phase_train``'s float32 ones (``f32``), and the step-0
    dropout-free loss of the two dtypes on the same weights and batch. Then
    ``phase_remat`` on the trained state. Returns the launches of K1 and
    K2."""
    import math

    import numpy as np
    import torch

    from tubedetr_tpu_torch.data.collate import collate_pairs
    from tubedetr_tpu_torch.data.synthetic import make_synthetic_sample
    from tubedetr_tpu_torch.models.layers import computing_in
    from tubedetr_tpu_torch.models.resnet import FrozenBatchNorm2d
    from tubedetr_tpu_torch.models.tubedetr import build_model
    from tubedetr_tpu_torch.ops.fused_bottleneck import fused_bottleneck_block
    from tubedetr_tpu_torch.ops.resize_normalize import resize_normalize
    from tubedetr_tpu_torch.parallel.train_step import create_train_state
    from tubedetr_tpu_torch.train.engine import train_one_epoch

    cfg = train_cfg().replace(compute_dtype="bfloat16").validate_training()
    h, w = TRAIN_HW
    phase_t0 = time.perf_counter()
    samples = [make_synthetic_sample(100 + i, t=TRAIN_T, h=h, w=w, vocab=cfg.text_vocab_size,
                                     text_len=12) for i in range(TRAIN_STEPS + 1)]
    pairs = collate_pairs(samples, 1, cfg.video_max_len_train, cfg.stride, cfg.max_text_len)
    torch.cuda.empty_cache()
    model = build_model(cfg)
    model.load_state_dict(fan_in_state_dict(model, seed=8))
    with computing_in(model, torch.float32):  # the same weights in float32 compute
        step0 = {"float32": deterministic_loss(cfg, model, pairs[0][0])}
    step0["bfloat16"] = deterministic_loss(cfg, model, pairs[0][0])
    torch.cuda.reset_peak_memory_stats()
    state = create_train_state(cfg, model)
    before = {n: t.detach().clone() for n, t in model.state_dict().items()}
    seen = {}

    def record(name):
        def hook(module, inputs, output):
            seen.setdefault(name, (output[0] if isinstance(output, tuple) else output).dtype)
        return hook

    hooks = [model.input_proj.register_forward_hook(record("input_proj")),
             model.transformer.decoder.layers[0].register_forward_hook(record("decoder.layers.0"))]
    resize_normalize.launches = 0
    fused_bottleneck_block.launches = 0
    step = timed_step(cfg)
    state, _ = train_one_epoch(cfg, step, state, pairs[:TRAIN_STEPS], 0, cfg.epochs * TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for hk in hooks:
        hk.remove()
    launches = {"resize_normalize": resize_normalize.launches,
                "fused_bottleneck": fused_bottleneck_block.launches}

    # checks
    for i, m in enumerate(step.metrics):
        bad = [k for k, v in m.items() if not math.isfinite(v)]
        if bad:
            fail(f"train-bf16: step {i} non-finite {bad}")
    if any(math.isnan(v) or math.isinf(v) for v in step0["bfloat16"].values()):
        fail(f"train-bf16: the step-0 losses are not finite: {step0['bfloat16']}")
    if seen != {"input_proj": torch.bfloat16, "decoder.layers.0": torch.bfloat16}:
        fail(f"train-bf16: the activations are {seen}, not bfloat16")
    moments = [v for st in state.optimizer.state.values() for v in st.values()
               if torch.is_tensor(v) and v.dim() > 0]
    dtypes = {"params": sorted({str(p.dtype) for p in model.parameters()}),
              "grads": sorted({str(p.grad.dtype) for p in model.parameters()
                               if p.grad is not None}),
              "adamw_moments": sorted({str(v.dtype) for v in moments}),
              "ema": sorted({str(v.dtype) for v in state.ema_params.values()})}
    if any(v != ["torch.float32"] for v in dtypes.values()) or not moments:
        fail(f"train-bf16: the state is not float32: {dtypes}")
    after = model.state_dict()
    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    frozen += [f"{m}.{b}" for m, mod in model.named_modules() if isinstance(mod, FrozenBatchNorm2d)
               for b, _ in mod.named_buffers()]
    moved = [n for n in frozen if not torch.equal(before[n], after[n])]
    if moved:
        fail(f"train-bf16: frozen tensors changed: {moved[:5]}")
    if launches["resize_normalize"] or launches["fused_bottleneck"]:
        fail(f"train-bf16: the training path launched K1 or K2: {launches}")

    extra_batch = pairs[TRAIN_STEPS][0]
    passes = train_trunk_passes(model, extra_batch, cfg)
    warm = [s["step_s"] for s in step.split[1:]]
    split = {k: float(np.median([s[k] for s in step.split[1:]]))
             for k in ("forward_loss_s", "backward_s", "clip_opt_ema_s")}
    line = {
        "card": smi, "steps": len(step.split), "cold_step_s": step.split[0]["step_s"],
        "warm_step_median_s": float(np.median(warm)), "warm_steps_s": warm,
        "warm_split_median_s": split, "trunk_passes_s": passes,
        "peak_memory_gib_remat_on": peak,
        "float32": {k: f32[k] for k in ("warm_step_median_s", "warm_split_median_s",
                                        "trunk_passes_s", "peak_memory_gib_remat_on")},
        "step0_dropout_free_loss": step0, "dtypes": dtypes, "activations": str(seen),
        "grad_norm_pre_clip": [m["grad_norm"] for m in step.metrics],
        "launches": launches, "phase_s": time.perf_counter() - phase_t0,
    }
    print(f"[train-bf16] {json.dumps(line)}", flush=True)
    del step
    phase_remat(smi, cfg, state, extra_batch)
    del state, model, pairs, samples
    torch.cuda.empty_cache()
    return launches, line


def quant_leg(smi: str, label: str, cfg, pairs):
    """One quantized training leg at full width: the model from the fan-in
    weights, its scales calibrated on the first batch (one observer
    forward, timed), then ``QUANT_STEPS`` steps of ``train_one_epoch``.
    Checks: every loss term finite; the frozen stem and layer1 and every
    FrozenBN buffer unchanged bit for bit, layer2-4 changed; K1 and K2
    never launched. Returns (line, model, state)."""
    import math

    import numpy as np
    import torch

    from tubedetr_tpu_torch.models.quantize import calibrate_qscales
    from tubedetr_tpu_torch.models.resnet import FrozenBatchNorm2d
    from tubedetr_tpu_torch.models.tubedetr import build_model
    from tubedetr_tpu_torch.ops.fused_bottleneck import fused_bottleneck_block
    from tubedetr_tpu_torch.ops.resize_normalize import resize_normalize
    from tubedetr_tpu_torch.parallel.train_step import create_train_state, model_inputs, to_device
    from tubedetr_tpu_torch.train.engine import train_one_epoch

    leg_t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    model.load_state_dict(fan_in_state_dict(model, seed=8))
    inputs = model_inputs(to_device(pairs[0][0], torch.device("cuda")))
    _, calibration_s = synced(lambda: calibrate_qscales(cfg, model, inputs))
    del inputs
    state = create_train_state(cfg, model)
    before = {n: t.detach().clone() for n, t in model.state_dict().items()}
    resize_normalize.launches = 0
    fused_bottleneck_block.launches = 0
    step = timed_step(cfg)
    state, _ = train_one_epoch(cfg, step, state, pairs[:QUANT_STEPS], 0,
                               cfg.epochs * QUANT_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {"resize_normalize": resize_normalize.launches,
                "fused_bottleneck": fused_bottleneck_block.launches}
    for i, m in enumerate(step.metrics):
        bad = [k for k, v in m.items() if not math.isfinite(v)]
        if bad:
            fail(f"{label}: step {i} non-finite {bad}")
    after = model.state_dict()
    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    if not frozen or any(not n.startswith(("backbone.0.body.conv1.", "backbone.0.body.layer1."))
                         for n in frozen):
        fail(f"{label}: the frozen parameters are not the stem and layer1: {frozen[:5]}")
    frozen += [f"{m}.{b}" for m, mod in model.named_modules() if isinstance(mod, FrozenBatchNorm2d)
               for b, _ in mod.named_buffers()]
    moved = [n for n in frozen if not torch.equal(before[n], after[n])]
    if moved:
        fail(f"{label}: frozen tensors changed: {moved[:5]}")
    for prefix in ("backbone.0.body.layer2.", "backbone.0.body.layer3.", "backbone.0.body.layer4."):
        names = [n for n, p in model.named_parameters() if n.startswith(prefix)]
        if all(torch.equal(before[n], after[n]) for n in names):
            fail(f"{label}: no parameter under {prefix} changed")
    if launches["resize_normalize"] or launches["fused_bottleneck"]:
        fail(f"{label}: the training path launched K1 or K2: {launches}")
    passes = train_trunk_passes(model, pairs[QUANT_STEPS][0], cfg)
    warm = [sp["step_s"] for sp in step.split[1:]]
    line = {
        "card": smi, "steps": len(step.split), "cold_step_s": step.split[0]["step_s"],
        "warm_step_median_s": float(np.median(warm)), "warm_steps_s": warm,
        "warm_split_median_s": {k: float(np.median([sp[k] for sp in step.split[1:]]))
                                for k in ("forward_loss_s", "backward_s", "clip_opt_ema_s")},
        "trunk_passes_s": passes, "peak_memory_gib_remat_on": peak,
        "calibration_s": calibration_s,
        "loss_total": [m["loss_total"] for m in step.metrics],
        "grad_norm_pre_clip": [m["grad_norm"] for m in step.metrics],
        "launches": launches, "leg_s": time.perf_counter() - leg_t0,
    }
    return line, model, state


def phase_train_quant(smi: str, bf16: dict):
    """The quantized training passes at full width (``[train-quant]``), the
    published training config in bfloat16 on ``phase_train_bf16``'s videos
    and weights: (1) ``int8_qat``: calibration, ``QUANT_STEPS`` steps, the
    split, trunk passes and peak beside ``[train-bf16]``'s (``bf16``); (5)
    the drift probe after them and one recalibration; (3) the deploy leg:
    leg 1's weights and scales written by ``checkpoint_payload``, reloaded
    by an int8_static + K2 ``GroundingPipeline`` at serving width, one
    request: the scales from the checkpoint (no calibration), K1 once and
    within its bound on the request's frames, K2 ``K2_PER_PASS`` times and
    exact against its plain version, boxes finite; (2) the float trunk with
    ``backbone_quant_fast`` and ``backbone_quant_frozen`` int8_static: the
    same prints, and the fast pass's features equal, bit for bit, those of
    an int8_static unfused trunk on the same weights, scales and frames;
    (4) ``resnet101-gn`` under int8_static (``fused_bottleneck`` asked) at
    serving width: a cold and a warm B=1 call, their seconds and peak, K2
    never launched. Returns the launches of K1 and K2 by leg."""
    import numpy as np
    import torch

    from tubedetr_tpu_torch.apps.pipeline import GroundingPipeline
    from tubedetr_tpu_torch.data.collate import collate_pairs
    from tubedetr_tpu_torch.data.synthetic import make_synthetic_sample
    from tubedetr_tpu_torch.models.quantize import make_drift_checker, model_qscales, recalibrate
    from tubedetr_tpu_torch.models.resnet import ResNet
    from tubedetr_tpu_torch.ops.fused_bottleneck import fused_bottleneck_block
    from tubedetr_tpu_torch.ops.resize_normalize import resize_normalize
    from tubedetr_tpu_torch.parallel.train_step import model_inputs, to_device
    from tubedetr_tpu_torch.train.checkpoint import checkpoint_payload, save_checkpoint

    phase_t0 = time.perf_counter()
    base = train_cfg().replace(compute_dtype="bfloat16")
    h, w = TRAIN_HW
    samples = [make_synthetic_sample(100 + i, t=TRAIN_T, h=h, w=w, vocab=base.text_vocab_size,
                                     text_len=12) for i in range(QUANT_STEPS + 1)]
    pairs = collate_pairs(samples, 1, base.video_max_len_train, base.stride, base.max_text_len)
    workdir = os.path.join(HERE, "tubedetr_tpu_torch", "build", "quant")
    os.makedirs(workdir, exist_ok=True)
    out = {}
    try:
        # (1) int8_qat, then (5) the drift probe and one recalibration
        cfg = base.replace(backbone_quant="int8_qat").validate_training()
        line, model, state = quant_leg(smi, "train-quant int8_qat", cfg, pairs)
        out["train int8_qat"] = line["launches"]
        line["bf16"] = {k: bf16[k] for k in ("warm_step_median_s", "warm_split_median_s",
                                            "trunk_passes_s", "peak_memory_gib_remat_on")}
        print(f"[train-quant] int8_qat: {json.dumps(line)}", flush=True)
        inputs = model_inputs(to_device(pairs[QUANT_STEPS][0], torch.device("cuda")))
        (ratio, leaf, observed), drift_s = synced(lambda: make_drift_checker(cfg)(model, inputs))
        _, recal_s = synced(lambda: recalibrate(cfg, model, observed))
        del inputs
        if not (np.isfinite(ratio) and ratio > 0 and leaf):
            fail(f"train-quant drift: ratio {ratio} at {leaf!r}")
        held = model_qscales(model)
        if any(float(held[k]) != float(v) for k, v in observed.items()):
            fail("train-quant drift: the recalibrated scales are not the observed maxima")
        drift = {"worst_observed_over_baked": ratio, "leaf": leaf, "drift_s": drift_s,
                 "recalibrate_s": recal_s}
        print(f"[train-quant] drift: {json.dumps(drift)}", flush=True)

        # (3) deploy: the QAT weights and scales served int8_static + K2
        ckpt = os.path.join(workdir, "qat.pth")
        payload = checkpoint_payload(state, 0, cfg, qscales=held)
        payload["optimizer"] = None  # serving reads no optimizer state
        save_checkpoint(ckpt, payload)
        del payload, state, model
        torch.cuda.empty_cache()
        clip = os.path.join(workdir, "request.npy")
        np.save(clip, np.random.RandomState(0).randint(0, 256, K1_SHAPE, dtype=np.uint8))
        pipe = GroundingPipeline(full_width_cfg("bfloat16", backbone_quant="int8_static",
                                                fused_bottleneck=True))
        pipe.reload(ckpt)
        if pipe._needs_calibration or pipe.qscales_source != "checkpoint":
            fail("train-quant deploy: the reload of the QAT checkpoint asks for calibration")
        if {k: float(v) for k, v in model_qscales(pipe.model).items()} != \
                {k: float(v) for k, v in held.items()}:
            fail("train-quant deploy: the pipeline does not hold the QAT checkpoint's scales")
        resize_normalize.launches = 0
        fused_bottleneck_block.launches = 0
        with K1Capture() as k1, K2Capture() as k2:
            result, request_s = synced(lambda: pipe.ground(clip, "a man in a red shirt",
                                                           render=False))
            launches = {"resize_normalize": resize_normalize.launches,
                        "fused_bottleneck": fused_bottleneck_block.launches}
        out["qat deploy int8_static+fused"] = launches
        if launches != {"resize_normalize": 1, "fused_bottleneck": K2_PER_PASS}:
            fail(f"train-quant deploy: the request launched {launches}; expected K1 once, "
                 f"K2 {K2_PER_PASS} times")
        if pipe.calibration_s:
            fail("train-quant deploy: the pipeline calibrated")
        check_tubes("train-quant deploy", [result])
        deploy = {"request_s": request_s, "segment": result["sted"], "launches": launches,
                  "k1_max_abs_err": k1.check("train-quant deploy"), "k2_max_abs_err": k2.check()}
        print(f"[train-quant] deploy: {json.dumps(deploy)}", flush=True)
        del pipe

        # (2) the float bf16 trunk, its fast pass and frozen prefix int8_static
        cfg = base.replace(backbone_quant_fast="int8_static",
                           backbone_quant_frozen="int8_static").validate_training()
        line, model, state = quant_leg(smi, "train-quant fast+frozen", cfg, pairs)
        out["train fast+frozen int8_static"] = line["launches"]
        body = model.backbone[0].body
        trunk = ResNet("resnet101", quant="int8_static", dtype=torch.bfloat16).cuda().eval()
        trunk.load_state_dict(body.state_dict())
        trunk.load_qscales(body.qscales())
        frames = pairs[QUANT_STEPS][0]["frames_fast"][0, 1:1 + QUANT_CHECK_FRAMES].cuda()
        with torch.no_grad():
            fast = model.backbone_feats(frames, **model.pass_modes(True))
            ref = trunk(frames.to(torch.bfloat16))
        line["fast_pass_equals_int8_static_trunk"] = bool(torch.equal(fast, ref))
        if not line["fast_pass_equals_int8_static_trunk"]:
            fail("train-quant fast+frozen: the fast pass differs from an int8_static trunk, max "
                 f"|diff| {(fast.float() - ref.float()).abs().max().item()}")
        print(f"[train-quant] fast+frozen int8_static: {json.dumps(line)}", flush=True)
        del model, state, trunk, fast, ref, frames
        torch.cuda.empty_cache()

        # (4) resnet101-gn under int8_static at serving width, B=1
        torch.cuda.reset_peak_memory_stats()
        pipe = GroundingPipeline(full_width_cfg("bfloat16", backbone="resnet101-gn",
                                                backbone_quant="int8_static",
                                                fused_bottleneck=True))
        fused_bottleneck_block.launches = 0
        result, cold_s = synced(lambda: pipe.ground(clip, "a man in a red shirt", render=False))
        result, warm_s = synced(lambda: pipe.ground(clip, "a man in a red shirt", render=False))
        gn = {"cold_ground_b1_s": cold_s, "calibration_s": pipe.calibration_s,
              "warm_ground_b1_s": warm_s,
              "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
              "segment": result["sted"], "k2_launches": fused_bottleneck_block.launches}
        check_tubes("train-quant gn", [result])
        if gn["k2_launches"]:
            fail(f"train-quant gn: the GroupNorm trunk launched K2 {gn['k2_launches']} times")
        print(f"[train-quant] resnet101-gn int8_static: {json.dumps(gn)}", flush=True)
        del pipe
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"[train-quant] phase_s {time.perf_counter() - phase_t0:.1f}", flush=True)
    return out


REMAT_POLICIES = ("full", "save_mid", "save_acts", "off")


def phase_remat(smi: str, cfg, state, batch):
    """The remat policies in bfloat16 on the trained full-width state: for
    each of ``REMAT_POLICIES``, two dropout-free forward + backward passes
    from the same parameters (the second timed), with
    ``torch.backends.cudnn.deterministic`` and deterministic kernels on; its
    seconds and peak memory (and the peak above the memory held before the
    forward), and its gradients, which must equal the ``full`` policy's bit
    for bit. The optimizer step is the same under every policy and is left
    out."""
    import torch

    from tubedetr_tpu_torch.models.resnet import KEPT_CONVS
    from tubedetr_tpu_torch.parallel.train_step import make_train_step, to_device

    model = state.model
    body = model.backbone[0].body
    batch = to_device(batch, torch.device("cuda"))
    step = make_train_step(cfg, deterministic=True)
    model.eval()
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    runs, ref = {}, None
    try:
        for policy in REMAT_POLICIES:
            body.remat = policy != "off"
            body.kept_convs = KEPT_CONVS.get(policy, ())
            for _ in range(2):
                model.zero_grad(set_to_none=True)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
                (total, _), fwd_s = synced(lambda: step.forward_loss(state, batch))
                _, bwd_s = synced(lambda: total.backward())
                del total
            peak = torch.cuda.max_memory_allocated()
            grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
            if ref is None:
                ref = {n: g.clone() for n, g in grads.items()}
            differ = [n for n, g in grads.items() if not torch.equal(g, ref[n])]
            runs[policy] = {"forward_s": fwd_s, "backward_s": bwd_s,
                            "forward_backward_s": fwd_s + bwd_s, "peak_memory_gib": peak / 2**30,
                            "peak_above_held_gib": (peak - held) / 2**30,
                            "grads_differing_from_full": len(differ)}
            if set(grads) != set(ref) or differ:
                fail(f"remat: the {policy} policy's gradients differ from full's: {differ[:5]}")
    finally:
        torch.backends.cudnn.deterministic = saved
        torch.use_deterministic_algorithms(False)
        body.remat, body.kept_convs = cfg.remat_backbone, KEPT_CONVS[cfg.remat_policy]
        model.zero_grad(set_to_none=True)
    print(f"[remat] {json.dumps({'card': smi, 'compute_dtype': cfg.compute_dtype, 'runs': runs})}",
          flush=True)

def cli_args(data: str, out: str, *extra) -> list:
    """The train CLI's argv over a VidSTG-layout directory, EMA on."""
    return ["--combine_datasets", "vidstg", "--combine_datasets_val", "vidstg",
            "--vidstg_ann_path", data, "--vidstg_vid_path", data, "--ema", "--output-dir", out,
            *extra]


def log_lines(out: str) -> list:
    with open(os.path.join(out, "log.txt")) as f:
        return [json.loads(line) for line in f]


class K2Capture:
    """Inside, the int8 trunk's K2 calls go through a wrapper that keeps the
    first ``(xq, fold, dilation)`` of each shape (the wrapped function still
    counts each launch); ``check`` then holds K2 to its plain version on
    those real inputs, launches that come after the counts are read."""

    def __enter__(self):
        from tubedetr_tpu_torch.models import resnet

        self.module, self.orig, self.seen = resnet, resnet.fused_bottleneck_block, {}

        def capture(xq, fold, dilation=1):
            key = (*xq.shape, dilation)
            if key not in self.seen:
                self.seen[key] = (xq.clone(), fold, dilation)
            return self.orig(xq, fold, dilation)

        resnet.fused_bottleneck_block = capture
        return self

    def __exit__(self, *exc):
        self.module.fused_bottleneck_block = self.orig
        return False

    def check(self) -> dict:
        import torch

        from tubedetr_tpu_torch.ops.fused_bottleneck import fused_bottleneck_plain

        out = {}
        for (n, h, w, c, d), (xq, fold, _) in sorted(self.seen.items()):
            got, so = self.orig(xq, fold, d)
            ref = fused_bottleneck_plain(xq, fold, d)
            err = (got.short() - ref.short()).abs().max().item()
            out[f"{n}x{h}x{w}x{c}/d{d}"] = err
            if err != 0 or not torch.equal(got, ref) or float(so) != float(fold.so):
                fail(f"cli: K2 at the CLI's shape {(n, h, w, c, d)} differs from its plain "
                     f"version, max |err| {err}")
        self.seen.clear()
        return out


class K1Capture:
    """Inside, the pipeline's K1 calls go through a wrapper that keeps the
    first call's arguments (the wrapped function still counts each launch);
    ``check`` then holds K1 to its plain version on those real frames, with
    ``phase_k1``'s tolerance, launches that come after the counts are read."""

    def __enter__(self):
        from tubedetr_tpu_torch.apps import pipeline

        self.module, self.orig, self.seen = pipeline, pipeline.resize_normalize, None

        def capture(frames, out_h, out_w, **kw):
            if self.seen is None:
                self.seen = (frames.clone(), out_h, out_w, kw)
            return self.orig(frames, out_h, out_w, **kw)

        pipeline.resize_normalize = capture
        return self

    def __exit__(self, *exc):
        self.module.resize_normalize = self.orig
        return False

    def check(self, label: str) -> float:
        import torch

        from tubedetr_tpu_torch.ops.resize_normalize import resize_normalize_plain

        frames, oh, ow, kw = self.seen
        out = self.orig(frames, oh, ow, **kw)
        ref32 = resize_normalize_plain(frames, oh, ow, kw.get("crop"), torch.float32,
                                       kw.get("pad_to"))
        err = (out.float() - ref32).abs()
        tol = (bf16_ulp(ref32) + F32_ATOL if out.dtype == torch.bfloat16
               else torch.full_like(ref32, F32_ATOL))
        if not bool((err <= tol).all()):
            fail(f"{label}: K1 on the request's frames differs from its plain version by "
                 f"{err.max().item()}")
        self.seen = None
        return err.max().item()


def upload_seconds(cfg, sample, tokenizer) -> dict:
    """Seconds (median of 5, between synchronizes) to copy one collated CLI
    batch of ``sample`` to the card from pinned memory (``non_blocking``)
    and from pageable memory, and its bytes."""
    import numpy as np
    import torch

    from tubedetr_tpu_torch.data.collate import collate

    out = {}
    for pinned in (True, False):
        batch = collate([sample], cfg.video_max_len, cfg.stride, cfg.max_text_len,
                        tokenizer=tokenizer, pin_memory=pinned)
        tensors = [torch.as_tensor(v) for v in batch.values()]
        tensors = [t.pin_memory() if pinned else t for t in tensors]
        secs = [synced(lambda: [t.to("cuda", non_blocking=pinned) for t in tensors])[1]
                for _ in range(5)]
        out["pinned" if pinned else "pageable"] = float(np.median(secs))
    out["bytes"] = sum(t.numel() * t.element_size() for t in tensors)
    return out


def phase_cli(smi: str):
    """The train and eval CLI (``apps/train.py:main``) at the published
    training config (the JAX ``config.py`` defaults: ResNet-101,
    RoBERTa-base, resolution 224, 200 frames at stride 5, B=1, float32, EMA,
    remat) over a VidSTG-layout directory written here: ``CLI_VIDEOS``
    train and val videos, each a seeded uint8 200x360x640 ``.npy`` at 5
    fps with the synthetic drifting square (about 830 MB, deleted at the
    end). In turn: (1) train one epoch with three loader threads and
    ``--device_prefetch 2``, one warm step traced, then eval and vIoU,
    ``checkpoint.pth``; (2) ``--resume`` it for epoch 1 with the same-thread
    feed and ``--async_checkpoint``; (3) ``--eval --load`` the checkpoint
    with int8_static and K2 (a ``--dataset_config`` overlay), K2 held to its
    plain version on the inputs it got (the data path does not bucket: maps
    of 53x94 to 7x12); (4) ``GroundingPipeline.reload`` of the checkpoint
    with the eval's scales embedded on an int8 + K2 pipeline, and one
    request (K1 pads to the bucket: maps of 56x96 to 7x12), K2 held to its
    plain version again. Returns the launches of K1 and K2 on the
    int8 eval and on the reload request."""
    import numpy as np
    import torch

    from tubedetr_tpu_torch.apps import train
    from tubedetr_tpu_torch.apps.cli import config_from_args
    from tubedetr_tpu_torch.apps.pipeline import GroundingPipeline
    from tubedetr_tpu_torch.data.datasets import build_dataset
    from tubedetr_tpu_torch.data.synthetic import write_vidstg_dir
    from tubedetr_tpu_torch.models.quantize import model_qscales
    from tubedetr_tpu_torch.models.tokenizer import build_tokenizer
    from tubedetr_tpu_torch.ops.fused_bottleneck import fused_bottleneck_block
    from tubedetr_tpu_torch.ops.resize_normalize import resize_normalize
    from tubedetr_tpu_torch.train import checkpoint

    phase_t0 = time.perf_counter()
    root = os.path.join(HERE, "tubedetr_tpu_torch", "build", "cli")
    shutil.rmtree(root, ignore_errors=True)
    data, out = os.path.join(root, "vidstg"), os.path.join(root, "out")
    line = {"card": smi}

    def counts():
        return {"resize_normalize": resize_normalize.launches,
                "fused_bottleneck": fused_bottleneck_block.launches}

    def zero():
        resize_normalize.launches = fused_bottleneck_block.launches = 0

    try:
        cfg = config_from_args(cli_args(data, out))
        t0 = time.perf_counter()
        write_vidstg_dir(data, *CLI_VIDEOS, t=CLI_CLIP[0], h=CLI_CLIP[1], w=CLI_CLIP[2], seed=11,
                         video_max_len_train=cfg.video_max_len_train)
        line["write_data_s"] = time.perf_counter() - t0
        tok = build_tokenizer(cfg.tokenizer_path, cfg.text_vocab_size)
        items, sets = {}, {}
        for split in ("train", "val"):
            ds = sets[split] = build_dataset("vidstg", split, cfg, tok)
            items[split] = [synced(lambda: ds[i])[1] for i in range(2)]
        line["getitem_s"] = items

        upload = upload_seconds(cfg, sets["train"][0], tok)

        # (1) train one epoch, eval, checkpoint
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero()
        run1 = train.RunStats(profile_step=CLI_PROFILE_STEP)
        _, run1_s = synced(lambda: train.main(cli_args(
            data, out, "--epochs", "1", "--num_workers", "3", "--device_prefetch", "2"), run1))
        launches_train = counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        if launches_train["resize_normalize"] or launches_train["fused_bottleneck"]:
            fail(f"cli: the float train run launched K1 or K2: {launches_train}")
        if [r["epoch"] for r in log_lines(out)] != [0] or run1.state.step != CLI_VIDEOS[0]:
            fail(f"cli: train run logged {log_lines(out)}, step {run1.state.step}")
        # warm steps: the first run's, the traced one aside, and the resumed run's
        warm = [s["step_s"] for i, s in enumerate(run1.steps) if i not in (0, CLI_PROFILE_STEP)]
        prof = device_profile(run1.profile, run1.steps[CLI_PROFILE_STEP]["step_s"])
        del run1.state
        torch.cuda.empty_cache()

        # (2) resume for epoch 1: the same-thread feed, the async writer
        zero()
        run2 = train.RunStats()
        out2 = os.path.join(root, "resumed")
        _, run2_s = synced(lambda: train.main(cli_args(
            data, out2, "--epochs", "2", "--resume", os.path.join(out, "checkpoint.pth"),
            "--num_workers", "3", "--device_prefetch", "0", "--async_checkpoint"), run2))
        warm += [s["step_s"] for s in run2.steps[1:]]
        if [r["epoch"] for r in log_lines(out2)] != [1] or run2.state.step != 2 * CLI_VIDEOS[0]:
            fail(f"cli: the resumed run logged {log_lines(out2)}, step {run2.state.step}; "
                 f"expected epoch 1 and step {2 * CLI_VIDEOS[0]}")
        del run2.state
        torch.cuda.empty_cache()

        # (3) the int8 + K2 eval of the checkpoint
        overlay = os.path.join(root, "int8.json")
        with open(overlay, "w") as f:
            json.dump({"backbone_quant": "int8_static", "fused_bottleneck": True}, f)
        run3 = train.RunStats()
        zero()
        with K2Capture() as cap:
            _, run3_s = synced(lambda: train.main(cli_args(
                data, os.path.join(root, "int8"), "--eval", "--load",
                os.path.join(out, "checkpoint.pth"), "--dataset_config", overlay,
                "--qscales_dir", os.path.join(root, "qscales"), "--num_workers", "3",
                "--device_prefetch", "2"), run3))
            launches_eval = counts()
        k2_cli = cap.check()
        if launches_eval != {"resize_normalize": 0,
                             "fused_bottleneck": K2_PER_PASS * CLI_VIDEOS[1]}:
            fail(f"cli: the int8 eval launched {launches_eval}; expected K2 {K2_PER_PASS} "
                 f"times for each of the {CLI_VIDEOS[1]} val forwards, K1 never")
        scales = model_qscales(run3.state.model)
        del run3.state
        torch.cuda.empty_cache()

        # (4) reload the checkpoint, its scales embedded, and serve one request
        ck = checkpoint.load_checkpoint(os.path.join(out, "checkpoint.pth"))
        ck["qscales"] = {k: torch.tensor(v) for k, v in scales.items()}
        ck["optimizer"] = None  # serving reads no optimizer state
        with_scales = os.path.join(root, "checkpoint_int8.pth")
        checkpoint.save_checkpoint(with_scales, ck)
        del ck
        pipe = GroundingPipeline(cfg.replace(backbone_quant="int8_static", fused_bottleneck=True))
        pipe.reload(with_scales)
        if pipe._needs_calibration or pipe.qscales_source != "checkpoint":
            fail("cli: the reload of a checkpoint with scales still asks for calibration")
        zero()
        with K2Capture() as cap:
            result, request_s = synced(lambda: pipe.ground(
                os.path.join(data, "val0.npy"), "the red square moving on the left",
                render=False))
            launches_reload = counts()
        k2_cli.update(cap.check())
        if launches_reload != {"resize_normalize": 1, "fused_bottleneck": K2_PER_PASS}:
            fail(f"cli: the reload request launched {launches_reload}; expected K1 once, "
                 f"K2 {K2_PER_PASS} times")
        if pipe.calibration_s or pipe.qscales_source != "checkpoint":
            fail("cli: the reloaded pipeline calibrated")
        s_, e_ = result["sted"]
        boxes = np.asarray(result["boxes"])
        if not (0 <= s_ < e_ <= CLI_CLIP[0]) or boxes.shape != (CLI_CLIP[0], 4) \
                or not np.isfinite(boxes).all():
            fail(f"cli: reload request gave segment {result['sted']}, boxes {boxes.shape}")
        del pipe

        line.update({
            "frame_hw_sampled": sorted(set(run1.frame_hw + run2.frame_hw)),
            "train_run_s": run1_s, "resume_run_s": run2_s, "int8_eval_run_s": run3_s,
            "warm_step_median_s": float(np.median(warm)), "warm_steps_s": warm,
            "cold_step_s": run1.steps[0]["step_s"], "resumed_first_step_s": run2.steps[0]["step_s"],
            "loader_wait_s_prefetch2": [s["wait_s"] for s in run1.steps],
            "loader_wait_s_prefetch0": [s["wait_s"] for s in run2.steps],
            "upload_s": upload,
            "upload_share_of_warm_step": {k: upload[k] / float(np.median(warm))
                                          for k in ("pinned", "pageable")},
            "profiled_step": {k: v for k, v in prof.items() if k != "top_kernels"},
            "peak_memory_gib_train": peak,
            "checkpoint_blocking_s": {"sync": run1.checkpoint_s, "async": run2.checkpoint_s},
            "viou": {"train": run1.evals, "resumed": run2.evals, "int8_eval": run3.evals},
            "launches": {"train": launches_train, "int8_eval": launches_eval,
                         "reload_request": launches_reload},
            "k2_cli_shapes_max_abs_err": k2_cli,
            "reload_request_s": request_s, "reload_segment": result["sted"],
        })
    finally:
        shutil.rmtree(root, ignore_errors=True)
    line["phase_s"] = time.perf_counter() - phase_t0
    print(f"[cli] {json.dumps(line)}", flush=True)
    print(f"[cli-profile] {json.dumps(prof['top_kernels'])}", flush=True)
    return {"int8_eval": launches_eval, "reload_request": launches_reload}


def phase_cli_small():
    """The train CLI at a tiny config on the card and on the CPU from the
    same seed and data, one epoch with ``--dropout 0`` and the dropout-free
    step (RoBERTa's own dropout does not follow ``--dropout``, and the two
    devices' masks differ): the ``log.txt`` losses within
    ``TRAIN_LOSS_RTOL``, the vIoU summaries within 1e-3."""
    import functools

    from tubedetr_tpu_torch.apps import train
    from tubedetr_tpu_torch.data.synthetic import write_vidstg_dir
    from tubedetr_tpu_torch.parallel import train_step

    root = os.path.join(HERE, "tubedetr_tpu_torch", "build", "cli-small")
    shutil.rmtree(root, ignore_errors=True)
    data = write_vidstg_dir(os.path.join(root, "vidstg"), 4, 2, t=20, h=60, w=80, seed=3,
                            video_max_len_train=20)
    tiny = ["--backbone", "resnet14", "--hidden_dim", "32", "--nheads", "4", "--enc_layers", "1",
            "--dec_layers", "1", "--dim_feedforward", "64", "--video_max_len", "20",
            "--video_max_len_train", "20", "--stride", "4", "--resolution", "128",
            "--max_text_len", "12", "--text_vocab_size", "128", "--text_hidden_size", "32",
            "--text_layers", "1", "--text_heads", "4", "--text_ffn", "64", "--batch_size", "2",
            "--epochs", "1", "--dropout", "0", "--num_workers", "2", "--device_prefetch", "2"]
    make = train_step.make_train_step
    train_step.make_train_step = functools.partial(make, deterministic=True)
    logs = {}
    try:
        for dev in ("cuda", "cpu"):
            out = os.path.join(root, dev)
            if train.main(cli_args(data, out, *tiny, "--device", dev)) != 0:
                fail(f"cli small: the {dev} run failed")
            (logs[dev],) = log_lines(out)
    finally:
        train_step.make_train_step = make
        shutil.rmtree(root, ignore_errors=True)
    card, cpu = logs["cuda"], logs["cpu"]
    losses = [k for k in cpu if k.startswith("train_loss")]
    viou = [k for k in cpu if k.startswith("test_")]
    loss_err = max(abs(card[k] - cpu[k]) / max(abs(cpu[k]), 1e-12) for k in losses)
    viou_err = max(abs(card[k] - cpu[k]) for k in viou)
    print(f"[cli-small] {json.dumps({'max_rel_err_losses': loss_err, 'viou_max_abs_diff': viou_err, 'card': card})}",
          flush=True)
    if set(card) != set(cpu) or not losses or not viou:
        fail(f"cli small: log keys differ card {sorted(card)} vs CPU {sorted(cpu)}")
    if not loss_err <= TRAIN_LOSS_RTOL:
        fail(f"cli small: losses differ card vs CPU by {loss_err} (relative)")
    if not viou_err <= 1e-3:
        fail(f"cli small: vIoU summaries differ card vs CPU by {viou_err}")


# the [dist] phase: a process a card, NCCL, the published training config
DIST_STEPS = {1: 2, 4: 6}  # steps of each run on 1 card and on 4
DIST_WAIT_S = 600.0  # the whole phase's ranks, from their start


def nccl_profile(prof, wall_s: float) -> dict:
    """A device trace of one step read for its NCCL kernels: their seconds,
    all kernels' seconds, and the NCCL seconds over the step's host wall
    time (NCCL kernels run on their own stream and may overlap compute)."""
    from torch.autograd import DeviceType

    nccl = total = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        total += us / 1e6
        if "nccl" in e.key.lower():
            nccl += us / 1e6
    return {"step_s_traced": wall_s, "device_kernel_s": total, "nccl_kernel_s": nccl,
            "nccl_share_of_step": nccl / wall_s if wall_s else None}


def dist_train_run(cfg, template, batch, mesh, steps: int, traced: bool, tp=None,
                   inventory: bool = False) -> dict:
    """``steps`` dropout-free train steps of the published model (a copy of
    ``template``) on ``batch``, spread over ``mesh`` (None: the unwrapped
    one-process state; ``tp``: ``parallelize``'s, True engages the model
    axis on any mesh), then, when ``traced``, one more under
    ``torch.profiler``, and with ``inventory`` one more whose collectives
    are recorded (``parallel/collectives.py``): each step's metrics and
    seconds, the peak memory over the run, the traced step, the
    inventory."""
    import copy
    import gc

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tubedetr_tpu_torch.parallel.train_step import create_train_state, parallelize
    from tubedetr_tpu_torch.train.optim import base_lrs

    gc.collect()  # the last run's state holds reference cycles (DDP, FSDP)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = copy.deepcopy(template)
    state = create_train_state(cfg, model)
    if mesh is not None:
        state = parallelize(cfg, state, mesh, tp=tp)
    lrs = base_lrs(cfg)
    step = timed_step(cfg, deterministic=True)
    for _ in range(steps):
        state, _ = step(state, batch, lrs, cfg.seed)
    peak = torch.cuda.max_memory_allocated() / 2**30
    profiled = inv = None
    if traced:
        one = timed_step(cfg, deterministic=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            state, _ = one(state, batch, lrs, cfg.seed)
        profiled = nccl_profile(prof, one.split[0]["step_s"])
    if inventory:
        from tubedetr_tpu_torch.parallel.collectives import collective_inventory, summary_json

        one = timed_step(cfg, deterministic=True)
        colls = collective_inventory(lambda: one(state, batch, lrs, cfg.seed), mesh)
        inv = {"collectives": len(colls), "profiler_events": colls.profiler_events,
               "rank_bytes": sum(c.rank_bytes for c in colls), "by_kind_axes": summary_json(colls)}
    warm = [s["step_s"] for s in step.split[1:]] or [step.split[0]["step_s"]]
    layout = getattr(state.model, "tp_layout", None)
    out = {"metrics": step.metrics, "step_s": [s["step_s"] for s in step.split],
           "warm_step_median_s": float(np.median(warm)), "peak_memory_gib": peak,
           "profile": profiled, "inventory": inv,
           "tp_split_tensors": 0 if layout is None else len(layout.splits)}
    del state, model, step
    torch.cuda.empty_cache()
    return out


def dist_int8_eval(cfg, weights, sample, mesh, tp: bool = False) -> dict:
    """The ``--eval`` forward of the int8_static + K2 model on one 200-frame
    video with the trunk's frames split over ``mesh``'s time group (with
    ``tp``, the transformer and RoBERTa cut over its model group,
    ``place_variables_tp``, the trunk replicated):
    calibrated on the video (every frame on each rank, the ranks' maximum),
    K2's launches counted over the forward alone, each K2 call's real input
    held exactly to the plain version after the count was read, and the
    boxes against the same model's forward with every frame on this rank."""
    import torch

    from tubedetr_tpu_torch.data.collate import collate
    from tubedetr_tpu_torch.models.quantize import calibrate_qscales
    from tubedetr_tpu_torch.models.tubedetr import build_model
    from tubedetr_tpu_torch.ops.fused_bottleneck import fused_bottleneck_block
    from tubedetr_tpu_torch.parallel.train_step import (
        TrainState,
        make_eval_step,
        model_inputs,
        to_device,
    )

    qcfg = cfg.replace(backbone_quant="int8_static", fused_bottleneck=True, mesh_time=mesh.time)
    model = build_model(qcfg)
    model.load_state_dict(weights)
    if tp:
        from tubedetr_tpu_torch.parallel.tp import place_variables_tp

        place_variables_tp(model, mesh, qcfg)
    model.time_group = mesh.time_group if mesh.time > 1 else None
    device = next(model.parameters()).device
    batch = to_device(collate([sample], qcfg.video_max_len, qcfg.stride, qcfg.max_text_len), device)
    calibrate_qscales(qcfg, model, model_inputs(batch))
    eval_step = make_eval_step(qcfg)
    state = TrainState(model, None, {}, None)
    eval_step(state, batch)  # warm
    fused_bottleneck_block.launches = 0
    with K2Capture() as cap:
        (out, _), sec = synced(lambda: eval_step(state, batch))
    launches = fused_bottleneck_block.launches
    k2_err = cap.check()
    model.time_group = None
    whole, _ = eval_step(state, batch)
    diff = float((out["pred_boxes"] - whole["pred_boxes"]).abs().max())
    res = {"frames_a_rank": -(-qcfg.video_max_len // mesh.time), "forward_s": sec,
           "k2_launches": launches, "k2_max_abs_err": k2_err, "boxes_vs_all_frames_here": diff}
    del model, state, out, whole
    torch.cuda.empty_cache()
    return res


# the [dist-pp] leg: the published encoder and decoder stacks pipelined
PP_MICRO = 4  # microbatches
PP_CLIPS, PP_VIDEOS, PP_TOKENS = 40, 4, 103  # 200 frames / stride 5; 7 x 13 + 12 tokens
# relative L2 error of the pipelined stacks against the sequential stack run
# on the same microbatches (the same products: rounding only), and against
# the sequential stack on the whole batch, whose products the card's kernels
# sum in another order (2.5e-4 on the decoder's gradients on an H100)
PP_RTOL, PP_WHOLE_BATCH_RTOL = 1e-5, 1e-2


def dist_pp(world: int) -> dict:
    """The published encoder and decoder stacks (6 layers each, 256 wide, 8
    heads, FFN 2048, float32 without TF32, seeded alike on every rank)
    pipelined with ``PP_MICRO`` microbatches over pipe=1 on one card and
    pipe=2 x data=2 on four, against the sequential stacks on the same
    inputs, run on each microbatch alone and on the whole batch (and the
    whole batch once more, for the run-to-run spread): the outputs, the
    gradients of this stage's layers and of the inputs (a sum-of-squares
    loss), each ||diff|| / ||ref|| (a gradient that is zero in exact
    arithmetic, a key bias's, is noise on both); the seconds of a pipelined
    and a sequential forward + backward; the inventory of one pipelined
    step."""
    import torch

    from tubedetr_tpu_torch.models.transformer import Decoder, Encoder
    from tubedetr_tpu_torch.parallel.collectives import collective_inventory, summary_json
    from tubedetr_tpu_torch.parallel.pp import (
        make_pipe_mesh,
        pipelined_decoder_apply,
        pipelined_encoder_apply,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_pipe_mesh(1 if world == 1 else 2, 1 if world == 1 else world // 2)
    torch.manual_seed(11)
    d, h, ffn, n = 256, 8, 2048, 6
    enc, dec = Encoder(n, d, h, ffn).cuda(), Decoder(n, d, h, ffn).cuda()
    g = torch.Generator(device="cuda").manual_seed(12)

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=g) * scale

    x, pos = rand(PP_CLIPS, PP_TOKENS, d), rand(PP_CLIPS, PP_TOKENS, d, scale=0.3)
    mask = torch.rand(PP_CLIPS, PP_TOKENS, device="cuda", generator=g) > 0.9
    mask[:, 0] = False
    b, t = PP_VIDEOS, 200
    dec_in = [torch.zeros(b, t, d, device="cuda"), rand(b, t, d, scale=0.3),
              rand(b, t, PP_TOKENS, d), rand(b, t, PP_TOKENS, d, scale=0.3)]
    dmask = torch.rand(b, t, PP_TOKENS, device="cuda", generator=g) > 0.9
    dmask[..., 0] = False
    qpad = torch.arange(t, device="cuda")[None] >= torch.tensor([200, 170, 120, 60], device="cuda")[:, None]
    qpad[:, 0] = False
    own = range(mesh.stage * n // mesh.pipe, (mesh.stage + 1) * n // mesh.pipe)

    def split(fn, args, dim):
        """``fn`` on each microbatch of ``args`` alone, the outputs joined."""
        n = args[0].shape[0] // PP_MICRO
        parts = [fn(*[a[i * n:(i + 1) * n] for a in args]) for i in range(PP_MICRO)]
        return tuple(torch.cat([p[k] for p in parts], dim=dim) for k in range(len(parts[0])))

    def run(which, mode):
        """``mode``: "pipe", "seq" (the whole batch at once) or "seq_mb"
        (the sequential stack on each microbatch alone)."""
        for p in list(enc.parameters()) + list(dec.parameters()):
            p.grad = None
        if which == "encoder":
            xi = x.clone().requires_grad_(True)
            args = (xi, pos, mask)
            if mode == "pipe":
                outs = (pipelined_encoder_apply(enc.layers, *args, mesh=mesh,
                                                microbatches=PP_MICRO),)
            elif mode == "seq":
                outs = (enc(*args),)
            else:
                outs = split(lambda *a: (enc(*a),), args, 0)
            stack = enc.layers
        else:
            xi = dec_in[2].clone().requires_grad_(True)  # the memory: an aux input
            args = (dec_in[0], dec_in[1], xi, dec_in[3], dmask, qpad)
            if mode == "pipe":
                hs, tsa, cross = pipelined_decoder_apply(dec.layers, *args, mesh=mesh,
                                                         microbatches=PP_MICRO)
                outs = (dec.norm(hs), tsa, cross)
            elif mode == "seq":
                outs = dec(*args)
            else:
                outs = split(dec, args, 1)
            stack = dec.layers
        sum(o.float().square().mean() for o in outs).backward()
        grads = [q.grad.detach().clone() for i in own for q in stack[i].parameters()]
        return [o.detach() for o in outs], grads, xi.grad.detach().clone()

    out = {"mesh_data_pipe": [mesh.data, mesh.pipe], "stage": mesh.stage,
           "microbatches": PP_MICRO}
    for which in ("encoder", "decoder"):
        ref, _ = synced(lambda: run(which, "seq"))  # cold
        got, _ = synced(lambda: run(which, "pipe"))
        mb = run(which, "seq_mb")
        again = run(which, "seq")
        _, t_seq = synced(lambda: run(which, "seq"))
        _, t_pipe = synced(lambda: run(which, "pipe"))

        def rel(a, b):  # ||a - b|| / ||b|| over the tensors together
            a = torch.cat([t.double().reshape(-1) for t in a])
            b = torch.cat([t.double().reshape(-1) for t in b])
            return float((a - b).norm() / b.norm().clamp_min(1e-30))

        def errs(a, b):
            return {"outputs": rel(a[0], b[0]), "layer_grads": rel(a[1], b[1]),
                    "input_grad": rel([a[2]], [b[2]])}

        colls = collective_inventory(lambda: run(which, "pipe"), mesh)
        out[which] = {"max_rel_err": errs(got, mb), "vs_whole_batch": errs(got, ref),
                      "microbatched_vs_whole_batch": errs(mb, ref),
                      "whole_batch_rerun": errs(again, ref),
                      "pipelined_fwd_bwd_s": t_pipe,
                      "sequential_fwd_bwd_s": t_seq,
                      "inventory": {"collectives": len(colls),
                                    "profiler_events": colls.profiler_events,
                                    "rank_bytes": sum(c.rank_bytes for c in colls),
                                    "by_kind_axes": summary_json(colls)}}
    del enc, dec
    torch.cuda.empty_cache()
    return out


def dist_rank(rank: int, world: int) -> dict:
    """One rank's work in ``phase_dist``: the one-rank reference (rank 0,
    unwrapped, the global batch of ``world`` videos as ``world``
    microbatches), then DDP, ZeRO-1 and FSDP over every rank (on 4 cards also
    data=2 x time=2), then the model axis (on one card TP, TP + ZeRO-1 and
    TP + FSDP on a one-rank model group; on 4 data=2 x model=2 under
    TP + FSDP and TP + ZeRO-1, and model=4), each run with one more step's
    collective inventory; then the time-split int8 + K2 eval and the
    tensor-parallel one; then the pipelined stacks (``dist_pp``); and one
    bfloat16 step unwrapped (rank 0), under DDP and under FSDP. On one
    card no step is traced: its collectives launch no NCCL kernel."""
    import torch

    from tubedetr_tpu_torch.data.collate import collate
    from tubedetr_tpu_torch.data.synthetic import make_synthetic_sample
    from tubedetr_tpu_torch.models.layers import computing_in
    from tubedetr_tpu_torch.models.tubedetr import build_model
    from tubedetr_tpu_torch.parallel.mesh import make_mesh

    cfg = train_cfg()
    h, w = TRAIN_HW
    samples = [make_synthetic_sample(100 + i, t=TRAIN_T, h=h, w=w, vocab=cfg.text_vocab_size,
                                     text_len=12) for i in range(world)]
    torch.manual_seed(8)  # the vectors fan_in_state_dict keeps are the init's
    template = build_model(cfg)
    weights = fan_in_state_dict(template, seed=8)
    template.load_state_dict(weights)
    steps = DIST_STEPS.get(world, DIST_STEPS[4])
    traced = world > 1

    def batch(cfg_, part):
        return collate(part, cfg_.video_max_len_train, cfg_.stride, cfg_.max_text_len)

    out = {"rank": rank, "device": str(torch.cuda.current_device()), "runs": {}}
    if rank == 0:
        ref_cfg = cfg.replace(batch_size=world, grad_accum=world)
        out["ref"] = dist_train_run(ref_cfg, template, batch(ref_cfg, samples), None,
                                    steps if world == 1 else 1, traced=False)
    # (name, (data, time, model), config fields, tp)
    layouts = [("ddp", (world, 1, 1), {}, None),
               ("zero", (world, 1, 1), {"shard_optimizer_state": True}, None),
               ("fsdp", (world, 1, 1), {"shard_params": True}, None)]
    if world == 4:
        layouts += [("data2xtime2", (2, 2, 1), {"mesh_time": 2}, None),
                    ("tp+fsdp data2xmodel2", (2, 1, 2), {"shard_params": True}, None),
                    ("tp+zero data2xmodel2", (2, 1, 2), {"shard_optimizer_state": True}, None),
                    ("tp model4", (1, 1, 4), {}, None)]
    else:
        layouts += [("tp", (1, 1, 1), {}, True),
                    ("tp+zero", (1, 1, 1), {"shard_optimizer_state": True}, True),
                    ("tp+fsdp", (1, 1, 1), {"shard_params": True}, True)]
    for name, (data, time_, model_), extra, tp in layouts:
        mesh = make_mesh(data, time_, "cuda", model_)
        per = world // data
        run_cfg = cfg.replace(batch_size=per, grad_accum=per if model_ > 1 else 1, **extra)
        part = samples[mesh.data_rank * per:(mesh.data_rank + 1) * per]
        out["runs"][name] = dict(dist_train_run(run_cfg, template, batch(run_cfg, part), mesh,
                                                steps, traced, tp=tp, inventory=True),
                                 mesh=[data, time_, model_], tp=bool(tp or model_ > 1))
    # bfloat16 compute (the template's copies compute in bf16): the unwrapped
    # step (rank 0), then DDP and FSDP, one step each
    bf16 = cfg.replace(compute_dtype="bfloat16")
    out["runs_bf16"] = {}
    with computing_in(template, torch.bfloat16):
        if rank == 0:
            ref_cfg = bf16.replace(batch_size=world, grad_accum=world)
            out["ref_bf16"] = dist_train_run(ref_cfg, template, batch(ref_cfg, samples), None, 1,
                                             traced=False)
        for name, extra in (("ddp bf16", {}), ("fsdp bf16", {"shard_params": True})):
            mesh = make_mesh(world, 1, "cuda")
            run_cfg = bf16.replace(batch_size=1, **extra)
            part = samples[mesh.data_rank:mesh.data_rank + 1]
            out["runs_bf16"][name] = dist_train_run(run_cfg, template, batch(run_cfg, part),
                                                    mesh, 1, traced=False)
    del template
    out["int8"] = dist_int8_eval(cfg, weights, samples[0], make_mesh(1, world, "cuda"))
    out["int8_tp"] = dist_int8_eval(cfg, weights, samples[0], make_mesh(1, 1, "cuda", world),
                                    tp=True)
    out["pp"] = dist_pp(world)
    return out


def _dist_entry(rank: int, world: int, port: int, results) -> None:
    import pickle
    import traceback

    try:
        import torch
        import torch.distributed as dist

        sys.path.insert(0, HERE)
        from tubedetr_tpu_torch.parallel.dist import init_process_group

        init_process_group(torch.device("cuda"), rank, world, f"tcp://127.0.0.1:{port}", rank)
        try:
            results.put((rank, True, pickle.dumps(dist_rank(rank, world))))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - sent to the parent, which fails the script
        results.put((rank, False, traceback.format_exc()))


def phase_dist(smi: str):
    """Multi-GPU training and evaluation: one process a card
    (``torch.cuda.device_count()``, spawned), NCCL, the published training
    config (ResNet-101, RoBERTa-base, 200 frames of 224x398, one video a
    card, dropout off). Rank 0 first runs the one-rank reference (unwrapped,
    the global batch as microbatches); then every rank runs DDP, ZeRO-1 and
    FSDP over all cards (on 4 cards also data=2 x time=2), then the model
    axis's runs (``dist_rank``), ``DIST_STEPS`` steps, one traced and one
    inventoried; each run's metrics are held to the reference (step 0,
    and on one card every step, where every collective is the identity)
    within ``TRAIN_LOSS_RTOL``. Then the int8_static + K2 eval with the
    frames split over every card (50 a card on 4) and the tensor-parallel
    one, K2 exact against its plain version on every rank, and the
    pipelined stacks (``dist_pp``). The ``[dist]``/``[dist-tp]`` lines:
    each run's warm step, peak memory and NCCL share per rank;
    ``[dist-comms]`` each step's collectives; ``[dist-int8]`` and
    ``[dist-tp]`` each rank's K2 launches; ``[dist-pp]`` the pipelines.
    Returns K2's launches on rank 0's two evals."""
    import pickle
    import queue
    import socket
    import subprocess

    import torch
    import torch.multiprocessing as mp

    world = torch.cuda.device_count()
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    if world > 1:
        topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True, text=True)
        for line in topo.stdout.splitlines():
            print(f"[dist-topo] {line}", flush=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_dist_entry, args=(r, world, port, results)) for r in range(world)]
    for p in procs:
        p.start()
    got, error = {}, None
    deadline = time.time() + DIST_WAIT_S
    try:
        while len(got) < world and error is None:
            try:
                rank, ok, res = results.get(timeout=max(1.0, deadline - time.time()))
            except queue.Empty:
                error = f"ranks {sorted(set(range(world)) - set(got))} sent nothing in {DIST_WAIT_S} s"
                break
            if ok:
                got[rank] = pickle.loads(res)
            else:
                error = f"rank {rank} failed:\n{res}"
    finally:
        for p in procs:
            p.join(timeout=30 if error is None else 1)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    if error is not None:
        fail(f"dist: {error}")
    ref = got[0]["ref"]
    compared = range(len(ref["metrics"])) if world == 1 else range(1)
    for name in got[0]["runs"]:
        errs = []
        for r in range(world):
            run = got[r]["runs"][name]
            err = max(abs(run["metrics"][i][k] - ref["metrics"][i][k]) / max(abs(ref["metrics"][i][k]), 1e-12)
                      for i in compared for k in ref["metrics"][i])
            errs.append(err)
            line = {"card": smi, "cards": world, "run": name,
                    "mesh_data_time_model": run["mesh"],
                    "rank": r, "steps": len(run["step_s"]), "cold_step_s": run["step_s"][0],
                    "warm_step_median_s": run["warm_step_median_s"],
                    "peak_memory_gib": run["peak_memory_gib"], "traced_step": run["profile"],
                    "loss_total_step0": run["metrics"][0]["loss_total"],
                    "grad_norm_step0": run["metrics"][0]["grad_norm"],
                    "max_rel_err_vs_one_rank": err, "tp_split_tensors": run["tp_split_tensors"]}
            print(f"[{'dist-tp' if run['tp'] else 'dist'}] {json.dumps(line)}", flush=True)
            inv = run["inventory"]
            print(f"[dist-comms] {json.dumps({'card': smi, 'cards': world, 'leg': name, 'rank': r, **inv})}",
                  flush=True)
            if inv["collectives"] == 0 or inv["collectives"] != inv["profiler_events"]:
                fail(f"dist: the {name} step's inventory holds {inv['collectives']} collectives, "
                     f"the profiler {inv['profiler_events']}")
            if any("?" in e["axes"] for e in inv["by_kind_axes"]):
                fail(f"dist: the {name} step launched a collective on no axis of its mesh")
            if run["tp"] and not run["tp_split_tensors"]:
                fail(f"dist: the {name} run cut no tensor over the model axis")
        if not max(errs) <= TRAIN_LOSS_RTOL:
            fail(f"dist: {name} differs from the one-rank run by {max(errs)} (relative) in its "
                 f"losses or grad norm")
    print(f"[dist] {json.dumps({'card': smi, 'cards': world, 'run': 'one-rank reference', 'warm_step_median_s': ref['warm_step_median_s'], 'peak_memory_gib': ref['peak_memory_gib'], 'grad_norm_step0': ref['metrics'][0]['grad_norm'], 'loss_total_step0': ref['metrics'][0]['loss_total']})}", flush=True)
    ref16 = got[0]["ref_bf16"]
    for name in got[0]["runs_bf16"]:
        errs = []
        for r in range(world):
            run = got[r]["runs_bf16"][name]
            err = max(abs(run["metrics"][0][k] - ref16["metrics"][0][k])
                      / max(abs(ref16["metrics"][0][k]), 1e-12) for k in ref16["metrics"][0])
            errs.append(err)
            line = {"card": smi, "cards": world, "run": name, "rank": r,
                    "cold_step_s": run["step_s"][0], "peak_memory_gib": run["peak_memory_gib"],
                    "loss_total_step0": run["metrics"][0]["loss_total"],
                    "grad_norm_step0": run["metrics"][0]["grad_norm"],
                    "one_rank_bf16_loss_total_step0": ref16["metrics"][0]["loss_total"],
                    "max_rel_err_vs_one_rank_bf16": err}
            print(f"[dist] {json.dumps(line)}", flush=True)
        if not max(errs) <= TRAIN_BF16_RTOL:
            fail(f"dist: {name} differs from the one-rank bf16 step by {max(errs)} (relative)")
    for r in range(world):
        for key, tag in (("int8", "dist-int8"), ("int8_tp", "dist-tp")):
            q = got[r][key]
            print(f"[{tag}] {json.dumps({'card': smi, 'cards': world, 'rank': r, 'eval': key, **q})}",
                  flush=True)
            if q["k2_launches"] != K2_PER_PASS:
                fail(f"dist: the {key} eval on rank {r} launched K2 {q['k2_launches']} times, "
                     f"not {K2_PER_PASS}")
    for r in range(world):
        pp = got[r]["pp"]
        for which in ("encoder", "decoder"):
            leg = pp[which]
            print(f"[dist-pp] {json.dumps({'card': smi, 'cards': world, 'rank': r, 'stack': which, 'mesh_data_pipe': pp['mesh_data_pipe'], 'stage': pp['stage'], 'microbatches': pp['microbatches'], **{k: v for k, v in leg.items() if k != 'inventory'}})}",
                  flush=True)
            inv = leg["inventory"]
            print(f"[dist-comms] {json.dumps({'card': smi, 'cards': world, 'leg': 'pp ' + which, 'rank': r, **inv})}",
                  flush=True)
            if not (max(leg["max_rel_err"].values()) <= PP_RTOL
                    and max(leg["vs_whole_batch"].values()) <= PP_WHOLE_BATCH_RTOL):
                fail(f"dist: the pipelined {which} differs from the sequential stack on rank {r}: "
                     f"{leg['max_rel_err']} (same microbatches), {leg['vs_whole_batch']} (whole "
                     "batch)")
            if inv["collectives"] != inv["profiler_events"] or any(
                    "?" in e["axes"] for e in inv["by_kind_axes"]):
                fail(f"dist: the pipelined {which}'s inventory on rank {r} is off: {inv}")
    print(f"[dist] phase took {time.perf_counter() - t0:.1f} s", flush=True)
    return got[0]["int8"]["k2_launches"], got[0]["int8_tp"]["k2_launches"]


def phase_prof(smi: str) -> dict:
    """The measuring entry points of ``scripts/`` (``tubedetr_tpu_torch/probes``),
    each at its script's shapes, on one card:

    * ``backbone_stages``: ResNet-101 (DC5, 200 frames of 352x352) cut after
      its stem and each stage group, in bf16 and in int8_static with K2 on
      the tails (``PROF_FUSED``); K2's launches in one call of each cut must
      be ``PROF_K2_BY_STAGES``; the whole int8_static trunk's call once more
      under ``torch.profiler`` (device activities), its top operations read
      by ``device_profile``; then EfficientNet-B0 in int8_static, whose whole
      trunk must launch G1 ``PROF_G1_B0`` times a call;
    * ``fused_block``: layer3 and layer4, K2 against the unfused int8 block,
      which must agree within the tests' bound (``PROF_K2_MAX_STEP``,
      ``PROF_K2_MIN_EQUAL``, against the float32 unfused route);
    * ``train_step``: the five variants, ``PROF_TRAIN_K`` steps each, one
      timed iteration; its JSON line with ``attribution_ms``;
    * ``int8_accuracy`` with K2 (``FUSED=1``): K2 ``K2_PER_PASS`` times in
      the int8 forward's one trunk pass, the readings finite;
    * ``int8_conv``; ``preprocess``, after K1 is held to its plain version
      on the probe's frames within a bf16 ulp (as ``phase_k1`` holds it);
      ``staging`` last, with the demand of this phase's own train step and
      int8_static + K2 trunk.

    Returns the launches by path of K1, K2 and G1."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tubedetr_tpu_torch.ops.fused_bottleneck import fused_bottleneck_block
    from tubedetr_tpu_torch.ops.resize_normalize import resize_normalize, resize_normalize_plain
    from tubedetr_tpu_torch.probes import backbone_stages, fused_block, int8_accuracy
    from tubedetr_tpu_torch.probes import int8_conv, preprocess, staging, train_step

    phase_t0 = time.perf_counter()
    torch.cuda.empty_cache()
    def say(text):  # the probes' own lines, each marked once
        print("\n".join(ln if ln.startswith("[prof]") else f"[prof] {ln}" for ln in text.split("\n")),
              flush=True)

    launches = {"fused_bottleneck": {}, "grouped_conv_s8": {}, "resize_normalize": {}}
    line = {"card": smi}

    def top_ops(model, x):
        with torch.inference_mode(), profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, sec = synced(lambda: model(x))
        line["top_ops_int8_static_k2_trunk"] = device_profile(prof, sec, PROF_TOP)
        print(f"[prof-top] {json.dumps(line['top_ops_int8_static_k2_trunk'])}", flush=True)

    # per-stage profiles
    tables = {}
    for label, kw in (("resnet101 bf16", dict(quant="none")),
                      ("resnet101 int8_static+K2", dict(quant="int8_static", fused=True,
                                                        on_full=top_ops)),
                      ("efficientnet_b0 int8_static", dict(arch="efficientnet_b0",
                                                           quant="int8_static"))):
        say(f"python -m tubedetr_tpu_torch.probes.backbone_stages ({label})")
        rec = backbone_stages.profile(**{"arch": "resnet101", **kw}, iters=PROF_ITERS, out=say)
        tables[label] = {"delta_ms": {rec["names"][n]: v * 1e3 for n, v in rec["delta_s"].items()},
                         "cum_ms": {rec["names"][n]: v * 1e3 for n, v in rec["times_s"].items()},
                         "launches_a_call": rec["launches"]}
        torch.cuda.empty_cache()
    k2_cuts = tables["resnet101 int8_static+K2"]["launches_a_call"]
    if tuple(k2_cuts[n] for n in range(5)) != PROF_K2_BY_STAGES:
        fail(f"[prof] K2 launches a call by truncation {k2_cuts}, expected {PROF_K2_BY_STAGES}")
    g1_cuts = tables["efficientnet_b0 int8_static"]["launches_a_call"]
    if g1_cuts[7] != PROF_G1_B0:
        fail(f"[prof] G1 launched {g1_cuts[7]} times in the whole B0 trunk, expected {PROF_G1_B0}")
    # one call of each truncation
    launches["fused_bottleneck"]["prof stages"] = sum(k2_cuts.values())
    launches["grouped_conv_s8"]["prof stages"] = sum(g1_cuts.values())
    line["stages"] = tables

    # K2 against the unfused block
    fused_bottleneck_block.launches = 0
    line["fused_block"] = {}
    for stage in ("layer3", "layer4"):
        say(f"python -m tubedetr_tpu_torch.probes.fused_block {stage}")
        rec = fused_block.run_stage(stage, out=say)
        line["fused_block"][stage] = rec
        if rec["max_diff_f32_all"] > PROF_K2_MAX_STEP or rec["agree_f32_all"] <= PROF_K2_MIN_EQUAL:
            fail(f"[prof] {stage}: K2 against the float32 unfused block: max step "
                 f"{rec['max_diff_f32_all']}, {rec['agree_f32_all']:.6f} equal; the tests hold "
                 f"<= {PROF_K2_MAX_STEP} and > {PROF_K2_MIN_EQUAL}")
    launches["fused_bottleneck"]["prof fused block"] = fused_bottleneck_block.launches
    torch.cuda.empty_cache()

    # the train step by part
    say(f"PROF_K={PROF_TRAIN_K} PROF_ITERS=1 python -m tubedetr_tpu_torch.probes.train_step")
    train = train_step.profile(train_step.make_config(), k=PROF_TRAIN_K, iters=1, out=say)
    print(f"[prof-train] {json.dumps(train)}", flush=True)
    line["train_step"] = train
    torch.cuda.empty_cache()

    # int8 against float at full width, K2 on the tails
    say("FUSED=1 python -m tubedetr_tpu_torch.probes.int8_accuracy")
    fused_bottleneck_block.launches = 0
    acc = int8_accuracy.run(fused=True, out=say)
    launches["fused_bottleneck"]["prof int8 accuracy"] = fused_bottleneck_block.launches
    if acc["k2_launches"] != K2_PER_PASS:
        fail(f"[prof] int8 accuracy: K2 launched {acc['k2_launches']} times in one trunk pass, "
             f"expected {K2_PER_PASS}")
    if not all(np.isfinite(acc[k]) for k in ("boxes_max_dev", "sted_max_dev", "boxes_corr")):
        fail(f"[prof] int8 accuracy: readings not finite: {acc}")
    line["int8_accuracy"] = acc
    torch.cuda.empty_cache()

    say("python -m tubedetr_tpu_torch.probes.int8_conv")
    line["int8_conv"] = int8_conv.run(out=say)
    torch.cuda.empty_cache()

    # K1 on the preprocess probe's frames, held to its plain version first
    res = 352
    frames = preprocess.make_frames(np.random.RandomState(0), device="cuda")
    out = resize_normalize(frames, res, res, out_dtype=torch.bfloat16).float()
    ref = resize_normalize_plain(frames, res, res, None, torch.float32)
    err = (out - ref).abs()
    if not bool((err <= bf16_ulp(ref) + F32_ATOL).all()):
        fail(f"[prof] K1 bf16 on the preprocess frames beyond 1 bf16 ulp + atol {F32_ATOL}: "
             f"max |err| {err.max().item()}")
    line["k1_max_abs_err"] = err.max().item()
    del frames, out, ref, err
    say("python -m tubedetr_tpu_torch.probes.preprocess")
    resize_normalize.launches = 0
    line["preprocess"] = preprocess.run(res=res, out=say)
    launches["resize_normalize"]["prof preprocess"] = resize_normalize.launches
    if not resize_normalize.launches:
        fail("[prof] the preprocess probe did not launch K1")
    torch.cuda.empty_cache()

    say("ITERS=1 python -m tubedetr_tpu_torch.probes.staging")
    trunk_s = tables["resnet101 int8_static+K2"]["cum_ms"]["layer4"] / 1e3
    line["staging"] = staging.run(iters=1, out=say, demand={
        "the train step (train_step probe, full)": train["ms"]["full"] / 1e3,
        "the int8_static + K2 trunk alone (backbone_stages)": trunk_s})
    line["phase_s"] = time.perf_counter() - phase_t0
    print(f"[prof] {json.dumps(line)}", flush=True)
    return launches

# [timm]: the three timm families at the widths the repo measured on the
# TPU (README), the trunk of each at full width with the headline model's
# transformer and RoBERTa-base; G1's launches a trunk pass (the depthwise
# convs of an EfficientNet-B0, the grouped 3x3 convs of a RegNetY-008)
TIMM_BACKBONES = ("timm_efficientnet_b0", "timm_regnety_008", "timm_convnext_tiny")
G1_PER_PASS = {"timm_efficientnet_b0": 16, "timm_regnety_008": 14, "timm_convnext_tiny": 0}
G1_FRAMES = 200  # one request's frames: G1 is checked and timed at this batch
G1_SHAPES = 19  # distinct G1 call shapes of the B0 and RegNetY-008 serving legs
# the stems' parameters, which must move in a training step whatever their gradient
TIMM_STEMS = tuple(f"backbone.0.body.{n}" for n in (
    "conv_stem.weight", "stem.conv.weight", "stem.0.weight", "stem.0.bias", "stem.1.weight",
    "stem.1.bias"))


class G1Capture:
    """Inside, the timm trunks' G1 calls go through a wrapper that keeps the
    first ``G1_FRAMES`` frames of the input, the weights and the scales of
    each distinct call shape and dtype, with how many launches of that shape
    a trunk pass makes (the wrapped function still counts each launch);
    ``phase_g1`` then holds G1 to its plain version on those real inputs and
    times it."""

    def __init__(self, seen: dict, backbone: str):
        self.seen, self.backbone = seen, backbone

    def __enter__(self):
        from tubedetr_tpu_torch.models import resnet

        self.module, self.orig = resnet, resnet.grouped_conv2d_int8
        self.calls = 0

        def capture(xq, wq, k, stride, groups, scale, dtype):
            key = (self.backbone, *xq.shape[1:], wq.shape[0], k, stride, groups,
                   str(dtype).replace("torch.", ""))
            if key not in self.seen:
                self.seen[key] = {"xq": xq[:G1_FRAMES].clone(), "wq": wq.clone(),
                                  "scale": scale.clone(), "per_pass": 0}
            if self.calls < G1_PER_PASS[self.backbone]:  # the first pass's launches
                self.seen[key]["per_pass"] += 1
            self.calls += 1
            return self.orig(xq, wq, k, stride, groups, scale, dtype)

        resnet.grouped_conv2d_int8 = capture
        return self

    def __exit__(self, *exc):
        self.module.grouped_conv2d_int8 = self.orig
        return False


def timm_serve(label: str, cfg, reqs, backbone: str, g1_seen: dict):
    """A cold and a warm B=2 ``ground_many`` at full width: tubes in range,
    K1 once a request and held to its plain version on a request's frames,
    K2 never, G1 ``G1_PER_PASS`` times a trunk pass (calibration included).
    Returns (line, launches)."""
    import torch

    from tubedetr_tpu_torch.apps.pipeline import GroundingPipeline
    from tubedetr_tpu_torch.ops.fused_bottleneck import fused_bottleneck_block
    from tubedetr_tpu_torch.ops.int8_conv import grouped_conv2d_int8
    from tubedetr_tpu_torch.ops.resize_normalize import resize_normalize

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resize_normalize.launches = 0
    fused_bottleneck_block.launches = 0
    grouped_conv2d_int8.launches = 0
    with K1Capture() as k1, G1Capture(g1_seen, backbone):
        t0 = time.perf_counter()
        pipe = GroundingPipeline(cfg)
        build_s = time.perf_counter() - t0
        _, cold_s = synced(lambda: pipe.ground_many(reqs, render=False))
        results, warm_s = synced(lambda: pipe.ground_many(reqs, render=False))
    launches = {"resize_normalize": resize_normalize.launches,
                "fused_bottleneck": fused_bottleneck_block.launches,
                "grouped_conv_s8": grouped_conv2d_int8.launches}
    check_tubes(label, results)
    quantized = cfg.backbone_quant != "none"
    passes = 3 if quantized else 0  # calibration's observer pass and two forwards
    want = {"resize_normalize": 2 * len(reqs), "fused_bottleneck": 0,
            "grouped_conv_s8": G1_PER_PASS[backbone] * passes}
    if launches != want:
        fail(f"{label}: launches {launches}, expected {want}")
    line = {"build_s": build_s, "cold_ground_many_b2_s": cold_s, "warm_ground_many_b2_s": warm_s,
            "warm_per_request_s_b2": warm_s / 2, "cold_calibration_s": pipe.calibration_s,
            "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
            "frames_dtype": str(pipe.frames_dtype).replace("torch.", ""),
            "out_channels": pipe.model.backbone[0].body.out_channels,
            "segments": [r["sted"] for r in results], "launches": launches,
            "k1_max_abs_err": k1.check(label)}
    print(f"[timm] {label}: {json.dumps(line)}", flush=True)
    del pipe, results
    return line, launches


def g1_instance(mangled: str) -> str:
    """``dw_kernel<5,2,1,1>`` for G1's mangled kernel name: the template
    arguments (k, s, vector staging, bfloat16 out; the n8 tiles and
    bfloat16 out of the grouped kernel; 4-channel words and bfloat16 out of
    the direct one)."""
    import re

    m = re.search(r"(dw_kernel|grouped_mma_kernel|direct_kernel)I(.*?)EEv", mangled)
    if not m:
        return mangled
    args = re.findall(r"L[ib](\d+)", m.group(2))
    return m.group(1) + "<" + ",".join(args) + ">"


def phase_g1(seen: dict) -> dict:
    """G1 on the inputs the int8 serving legs gave it, cut to one request's
    ``G1_FRAMES`` frames, in the serving dtype: exactly its plain version
    (the float64 grouped conv rounded to int32, then the fold) at every
    shape, then timed (CUDA events) beside the plain version and the library
    call for the same folded function: a float32 cuDNN grouped conv on the
    int8 values (TF32 off), the cast in, the rounding and the fold out
    included, held to the plain version too. Its products and sums are
    integers below 2^24, so float32 holds them exactly; where it did not
    agree, the library call is the float64 one, the plain version. The bound
    counts the int8 input and weights, the scales and the folded output.
    Returns the kernels-line entry, summed over one EfficientNet-B0 trunk
    pass."""
    import torch
    from torch.nn import functional as F

    from tubedetr_tpu_torch.ops import _cuda_build
    from tubedetr_tpu_torch.ops.int8_conv import (
        g1_path,
        grouped_conv2d_int8,
        grouped_conv2d_int8_plain,
    )
    from tubedetr_tpu_torch.probes import cuda_ms

    torch.backends.cudnn.allow_tf32 = False  # as the port sets it (utils/device.py)
    cases = {}
    for key, v in sorted(seen.items()):
        backbone, h, w, c, o, k, stride, groups, dtype_name = key
        xq, wq, scale, dtype = v["xq"], v["wq"], v["scale"], getattr(torch, dtype_name)
        args = (xq, wq, k, stride, groups, scale, dtype)
        before = grouped_conv2d_int8.launches
        out = grouped_conv2d_int8(*args)
        ref = grouped_conv2d_int8_plain(*args)
        err = (out.double() - ref.double()).abs().max().item()
        grouped_conv2d_int8.launches = before  # a check, not the main path
        if err != 0 or not torch.equal(out, ref):
            fail(f"G1 {key}: differs from its plain version, max |err| {err}")
        n, ho, wo, _ = out.shape
        nbytes = xq.numel() + wq.numel() + 4 * scale.numel() + out.element_size() * out.numel()
        ops = 2 * out.numel() * wq.shape[1]
        bound_ms, bound_by = bound(nbytes, ops, INT8_OPS_PER_S)
        # the weights as a library route would keep them (cached, like _int8_weight's)
        wf = wq.float().reshape(o, k, k, c // groups).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        sc = scale.view(1, o, 1, 1)

        def library(xq=xq, wf=wf, sc=sc, k=k, stride=stride, groups=groups, dtype=dtype):
            # NCHW view of NHWC memory (channels_last) in, NHWC out
            y = F.conv2d(xq.float().permute(0, 3, 1, 2), wf, stride=stride, padding=k // 2,
                         groups=groups)
            return y.round_().mul_(sc).to(dtype).permute(0, 2, 3, 1)

        lib_err = (library().double() - ref.double()).abs().max().item()
        name = f"{backbone[5:]}:{n}x{h}x{w}x{c}/k{k}s{stride}g{groups}/{dtype_name}"
        cases[name] = {
            "backbone": backbone, "path": g1_path(xq, wq, k, stride, groups),
            "per_pass": v["per_pass"], "max_abs_err": err,
            "ms": cuda_ms(lambda: grouped_conv2d_int8(*args), groups=7, per_group=3),
            "plain_ms": cuda_ms(lambda: grouped_conv2d_int8_plain(*args), groups=3, per_group=1),
            "cudnn_f32_max_abs_err": lib_err,
            "cudnn_f32_ms": cuda_ms(library, groups=5, per_group=2),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        exact = lib_err == 0
        cases[name]["library"] = "float32 cuDNN" if exact else "float64 cuDNN (the plain version)"
        cases[name]["library_ms"] = cases[name]["cudnn_f32_ms" if exact else "plain_ms"]
        cases[name]["of_bound"] = bound_ms / cases[name]["ms"]
        grouped_conv2d_int8.launches = before
        print(f"[g1] {name}: {json.dumps(cases[name])}", flush=True)
        del out, ref, wf
        torch.cuda.empty_cache()
    if len(cases) != G1_SHAPES:
        fail(f"G1: {len(cases)} serving shapes captured, expected {G1_SHAPES}")
    head = "timm_efficientnet_b0"
    for backbone in ("timm_efficientnet_b0", "timm_regnety_008"):
        got = sum(v["per_pass"] for v in cases.values() if v["backbone"] == backbone)
        if got != G1_PER_PASS[backbone]:
            fail(f"G1: {got} launches a {backbone} pass captured, expected "
                 f"{G1_PER_PASS[backbone]}")

    def per_pass(key, backbone=head):
        return sum(v[key] * v["per_pass"] for v in cases.values() if v["backbone"] == backbone)

    b0 = [v for v in cases.values() if v["backbone"] == head]
    by_ops = sum(v["per_pass"] * v["bound_ms"] for v in b0 if v["bound_by"] == "operations")
    usage = _cuda_build.ptxas_usage(_cuda_build.build_log("grouped_conv_s8"))
    entry = {
        "name": "grouped_conv_s8",
        "route": "cuda",
        "source": "tubedetr_tpu_torch/csrc/grouped_conv_s8.cu",
        # not a TPU kernel: the XLA grouped int8 conv of the JAX BottleneckConv
        "replaces": "tubedetr_tpu/models/resnet.py:240",
        "launches": None,
        "max_abs_err": max(v["max_abs_err"] for v in cases.values()),
        "ms": per_pass("ms"),
        "plain_ms": per_pass("plain_ms"),
        "bound_ms": per_pass("bound_ms"),
        "bound_by": "operations" if by_ops >= per_pass("bound_ms") - by_ops else "bytes",
        # cuDNN's float32 grouped conv on the int8 values, rounded and
        # folded, exact at every shape where "library" says so (else the
        # float64 call there)
        "library_ms": per_pass("library_ms"),
        "library": sorted({v["library"] for v in cases.values()}),
        "library_max_abs_err_f32": max(v["cudnn_f32_max_abs_err"] for v in cases.values()),
        "per": f"one EfficientNet-B0 trunk pass of one request ({G1_FRAMES} frames of "
               f"{K1_PAD[0]}x{K1_PAD[1]}, bfloat16 out): {G1_PER_PASS[head]} launches",
        "regnety_008_pass": {k: per_pass(k, "timm_regnety_008")
                             for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
        "registers_spill_bytes": {g1_instance(name): [u["registers"],
                                                      u["spill_store_bytes"] + u["spill_load_bytes"]]
                                  for name, u in usage.items()},
        "cases": cases,
    }
    print(f"[g1] per B0 pass: {entry['ms']:.3f} ms (bound {entry['bound_ms']:.3f} ms, plain "
          f"{entry['plain_ms']:.3f} ms, library {entry['library_ms']:.3f} ms, "
          f"{entry['library']}); per RegNetY-008 pass: {entry['regnety_008_pass']}; "
          f"registers and spill bytes: {entry['registers_spill_bytes']}", flush=True)
    return entry


class QuantNoise:
    """Inside, every int8 quantizer of the timm trunks first multiplies its
    input by ``1 + 2^-23 u``, ``u`` uniform in [-1, 1] from ``seed``: at
    most one float32 ulp, what another summation order leaves on a value.
    The CPU model against itself so gives the noise floor of an int8
    comparison between two devices."""

    def __init__(self, seed: int):
        self.seed = seed

    def __enter__(self):
        import torch

        from tubedetr_tpu_torch.models import resnet

        self.module, self.orig = resnet, resnet.quantize_act
        gen = torch.Generator().manual_seed(self.seed)

        def noisy(x, act_max, mode, observe):
            u = torch.rand(x.shape, generator=gen, dtype=torch.float64) * 2 - 1
            return self.orig((x.double() * (1 + 2.0 ** -23 * u)).float(), act_max, mode, observe)

        resnet.quantize_act = noisy
        return self

    def __exit__(self, *exc):
        self.module.quantize_act = self.orig
        return False


def int8_readings(a, b, trunk_a, trunk_b) -> dict:
    """How far one int8 forward lies from another: the trunk's correlation
    and largest difference in steps of its own scale, the heads' largest
    differences."""
    import numpy as np

    steps = np.abs(trunk_a - trunk_b) / (np.abs(trunk_b).max() / 127.0)
    out = {"trunk_corr": float(np.corrcoef(trunk_a.ravel(), trunk_b.ravel())[0, 1]),
           "trunk_max_steps": float(steps.max()),
           "trunk_differing": float((steps > 0.5).mean())}
    for k in SMALL_INT8_ATOL:
        out[k] = float(np.abs(a[k] - b[k]).max())
    return out


def timm_int8_noise(cpu, sample, out, trunk) -> dict:
    """The noise floor of ``cpu``'s int8 forward on ``sample`` (whose
    outputs are ``out`` and trunk output ``trunk``): the worst of
    ``SMALL_TIMM_NOISE_DRAWS`` ``QuantNoise`` draws, key by key."""
    import torch

    worst = {}
    for seed in range(SMALL_TIMM_NOISE_DRAWS):
        with QuantNoise(seed):
            noisy = cpu.forward([sample])[0]
            with torch.inference_mode():
                t = cpu.model.backbone[0].body(sample.frames.float()).float().numpy()
        r = int8_readings(noisy, out, t, trunk)
        for k, v in r.items():
            worst[k] = min(worst.get(k, v), v) if k == "trunk_corr" else max(worst.get(k, v), v)
    return worst


def phase_timm_small(workdir: str):
    """Each family on the small config, card against CPU from the same
    seeded weights (``fan_in_state_dict``) and frames: float (every output
    to ``SMALL_ATOL``) and int8_static (the CPU calibrates, the card serves
    the same scales on the same bfloat16 frames, G1 launched on the card),
    held to a few times the CPU's own noise floor (``timm_int8_noise``,
    ``SMALL_TIMM_TRUNK_X``, ``SMALL_TIMM_HEADS_X``)."""
    import numpy as np
    import torch

    from tubedetr_tpu_torch.apps.pipeline import GroundingPipeline
    from tubedetr_tpu_torch.models.quantize import model_qscales
    from tubedetr_tpu_torch.ops.int8_conv import grouped_conv2d_int8

    path = os.path.join(workdir, "small.npy")
    for i, backbone in enumerate(TIMM_BACKBONES):
        cfg = small_cfg().replace(backbone=backbone)
        pipes = {dev: GroundingPipeline(cfg, device=dev) for dev in ("cuda", "cpu")}
        # weights at a trained model's scale: at the seed's 0.02 the
        # activations of a deep trunk fall below the quantizer's floor
        weights = fan_in_state_dict(pipes["cpu"].model, seed=30 + i)
        outs = {}
        for dev, pipe in pipes.items():
            pipe.model.load_state_dict(weights)
            outs[dev] = pipe.forward([pipe.prepare(path, "a red square", -1, -1, "v")[0]])[0]
        errs = {k: float(np.abs(outs["cuda"][k] - outs["cpu"][k]).max()) for k in outs["cpu"]}
        if not max(errs.values()) <= SMALL_ATOL:
            fail(f"timm small {backbone}: card and CPU differ: {errs}")
        line = {"float_max_abs_err": errs}
        qcfg = cfg.replace(backbone_quant="int8_static", fused_bottleneck=True)
        cpu = GroundingPipeline(qcfg, device="cpu")
        cpu.model.load_state_dict(weights)
        sample, _ = cpu.prepare(path, "a red square", -1, -1, "v")
        q = {"cpu": cpu.forward([sample])[0]}  # calibrates on the CPU
        frames_cpu = sample.frames
        with torch.inference_mode():
            trunk_cpu = cpu.model.backbone[0].body(frames_cpu.float()).float().numpy()
        float_cpu = pipes["cpu"].forward([sample])[0]  # the same bf16 frames, float trunk
        line["int8_vs_float_cpu"] = {k: float(np.abs(q["cpu"][k] - float_cpu[k]).max())
                                     for k in SMALL_INT8_ATOL}
        line["cpu_noise_floor"] = noise = timm_int8_noise(cpu, sample, q["cpu"], trunk_cpu)
        card = GroundingPipeline(qcfg, device="cuda")
        card.model.load_state_dict(weights)
        card.set_qscales(model_qscales(cpu.model))
        sample.frames = frames_cpu.cuda()
        before = grouped_conv2d_int8.launches
        q["cuda"] = card.forward([sample])[0]
        line["g1_launches"] = g1 = grouped_conv2d_int8.launches - before
        if (g1 > 0) != (G1_PER_PASS[backbone] > 0):
            fail(f"timm small {backbone}: the card's int8 forward launched G1 {g1} times")
        with torch.inference_mode():
            trunk_card = card.model.backbone[0].body(sample.frames.float()).float().cpu().numpy()
        line["card_vs_cpu"] = got = int8_readings(q["cuda"], q["cpu"], trunk_card, trunk_cpu)
        line["bounds"] = bounds = {
            "trunk_corr": 1 - SMALL_TIMM_TRUNK_X * (1 - noise["trunk_corr"]),
            **{k: max(SMALL_INT8_ATOL[k], SMALL_TIMM_HEADS_X * noise[k]) for k in SMALL_INT8_ATOL}}
        print(f"[timm-small] {backbone}: {json.dumps(line)}", flush=True)
        if not got["trunk_corr"] >= bounds["trunk_corr"]:
            fail(f"timm small {backbone} int8: trunk correlation card vs CPU "
                 f"{got['trunk_corr']} (bound {bounds['trunk_corr']})")
        for k in SMALL_INT8_ATOL:
            if not got[k] <= bounds[k]:
                fail(f"timm small {backbone} int8: {k} differs between card and CPU by "
                     f"{got[k]} (bound {bounds[k]})")
        del cpu, card, pipes


def timm_train_step(smi: str, cfg, label: str, calibrate: bool = False):
    """One step of ``cfg`` at the published training config's frames from
    the fan-in weights: every loss term finite, every trunk parameter's
    gradient finite and not all zero, every trunk parameter whose gradient
    reaches 1e-6 moved and the stem's always (ConvNeXt's ``stem.1``
    LayerNorm among them), every FrozenBN buffer unchanged bit for bit; K1
    and K2 never launched. Returns (line, launches)."""
    import math

    import torch

    from tubedetr_tpu_torch.data.collate import collate_pairs
    from tubedetr_tpu_torch.data.synthetic import make_synthetic_sample
    from tubedetr_tpu_torch.models.quantize import calibrate_qscales
    from tubedetr_tpu_torch.models.resnet import FrozenBatchNorm2d
    from tubedetr_tpu_torch.models.tubedetr import build_model
    from tubedetr_tpu_torch.ops.fused_bottleneck import fused_bottleneck_block
    from tubedetr_tpu_torch.ops.int8_conv import grouped_conv2d_int8
    from tubedetr_tpu_torch.ops.resize_normalize import resize_normalize
    from tubedetr_tpu_torch.parallel.train_step import create_train_state, model_inputs, to_device
    from tubedetr_tpu_torch.train.optim import base_lrs

    h, w = TRAIN_HW
    sample = make_synthetic_sample(100, t=TRAIN_T, h=h, w=w, vocab=cfg.text_vocab_size, text_len=12)
    ((batch, _),) = collate_pairs([sample], 1, cfg.video_max_len_train, cfg.stride,
                                  cfg.max_text_len)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    model.load_state_dict(fan_in_state_dict(model, seed=8))
    calibration_s = None
    if calibrate:
        inputs = model_inputs(to_device(batch, torch.device("cuda")))
        _, calibration_s = synced(lambda: calibrate_qscales(cfg, model, inputs))
        del inputs
    state = create_train_state(cfg, model)
    before = {n: t.detach().clone() for n, t in model.state_dict().items()}
    resize_normalize.launches = 0
    fused_bottleneck_block.launches = 0
    grouped_conv2d_int8.launches = 0
    step = timed_step(cfg, keep_grads=True)
    state, _ = step(state, batch, base_lrs(cfg), cfg.seed)
    launches = {"resize_normalize": resize_normalize.launches,
                "fused_bottleneck": fused_bottleneck_block.launches,
                "grouped_conv_s8": grouped_conv2d_int8.launches}
    bad = [k for k, v in step.metrics[0].items() if not math.isfinite(v)]
    if bad:
        fail(f"{label}: non-finite {bad}")
    trunk = [n for n, _ in model.named_parameters() if n.startswith("backbone.")]
    dead = [n for n in trunk if n not in step.grads or not bool(torch.isfinite(step.grads[n]).all())
            or not bool(step.grads[n].any())]
    after = model.state_dict()
    # AdamW's first step moves an element by lr * g / (|g| + 1e-8): a
    # parameter whose gradient stays below 1e-6 may move by less than an ulp
    still = [n for n in trunk if torch.equal(before[n], after[n])
             and (float(step.grads[n].abs().max()) > 1e-6 or n in TIMM_STEMS)]
    if dead or still or not trunk:
        fail(f"{label}: trunk parameters without a gradient {dead[:5]} or unmoved {still[:5]}")
    frozen = [f"{m}.{b}" for m, mod in model.named_modules() if isinstance(mod, FrozenBatchNorm2d)
              for b, _ in mod.named_buffers()]
    moved = [n for n in frozen if not torch.equal(before[n], after[n])]
    if moved:
        fail(f"{label}: FrozenBN buffers changed: {moved[:5]}")
    if launches["resize_normalize"] or launches["fused_bottleneck"]:
        fail(f"{label}: the training path launched K1 or K2: {launches}")
    line = {"card": smi, "cold_step_s": step.split[0]["step_s"], "split_s": step.split[0],
            "loss_total": step.metrics[0]["loss_total"],
            "grad_norm_pre_clip": step.metrics[0]["grad_norm"],
            "trunk_parameters_trained": len(trunk), "frozen_bn_buffers": len(frozen),
            "trunk_parameters_moved": sum(not torch.equal(before[n], after[n]) for n in trunk),
            "calibration_s": calibration_s,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": launches}
    print(f"[timm-train] {label}: {json.dumps(line)}", flush=True)
    del state, model, step
    torch.cuda.empty_cache()
    return line, launches


def phase_timm(workdir: str, smi: str):
    """The timm families (``[timm]``): each at full width in bf16 and in
    int8_static with ``fused_bottleneck`` on (K2 never launched, G1
    ``G1_PER_PASS`` times a trunk pass); G1 held exactly to its plain
    version and timed on the inputs those legs gave it; each family on the
    small config card against CPU; one bf16 training step of the published
    config with each family, and one float32 ``int8_qat`` +
    ``backbone_quant_fast int8_static`` step with EfficientNet-B0 (its fast
    pass launches G1).
    Returns (the G1 entry, launches by path)."""
    import torch

    phase_t0 = time.perf_counter()
    reqs = [(os.path.join(workdir, f"request{i}.npy"), q, -1.0, -1.0)
            for i, q in enumerate(("a man in a red shirt rides a horse",
                                   "the dog runs across the grass"))]
    g1_seen, by_path = {}, {}
    for backbone in TIMM_BACKBONES:
        for mode in ("bf16", "int8_static"):
            extra = {"backbone_quant": "int8_static", "fused_bottleneck": True} \
                if mode == "int8_static" else {}
            label = f"{backbone[5:]} {mode} full width"
            _, by_path[label] = timm_serve(label, full_width_cfg("bfloat16", backbone=backbone,
                                                                 **extra), reqs, backbone, g1_seen)
    torch.cuda.empty_cache()
    entry = phase_g1(g1_seen)
    del g1_seen
    torch.cuda.empty_cache()
    phase_timm_small(workdir)
    by_path.update(phase_timm_train(smi))
    print(f"[timm] phase took {time.perf_counter() - phase_t0:.1f} s", flush=True)
    return entry, by_path


def phase_timm_train(smi: str) -> dict:
    """One bf16 step of the published training config with each family,
    then one float32 ``int8_qat`` + ``backbone_quant_fast int8_static``
    step with EfficientNet-B0 (G1 ``G1_PER_PASS`` times: its fast pass).
    Returns the launches by leg."""
    by_path = {}
    for backbone in TIMM_BACKBONES:
        cfg = train_cfg().replace(backbone=backbone, compute_dtype="bfloat16").validate_training()
        label = f"{backbone[5:]} bf16 train"
        _, by_path[label] = timm_train_step(smi, cfg, label)
        if by_path[label]["grouped_conv_s8"]:
            fail(f"{label}: the float training step launched G1")
    # in float32: in bf16 the QAT convs' depthwise backward on cuDNN took
    # 10.9 s of a 15.1 s cold step (float32's float convs: 2.6 s)
    cfg = train_cfg().replace(backbone="timm_efficientnet_b0", backbone_quant="int8_qat",
                              backbone_quant_fast="int8_static").validate_training()
    label = "efficientnet_b0 f32 int8_qat+fast int8_static train"
    _, by_path[label] = timm_train_step(smi, cfg, label, calibrate=True)
    if by_path[label]["grouped_conv_s8"] != G1_PER_PASS["timm_efficientnet_b0"]:
        fail(f"{label}: G1 launched {by_path[label]['grouped_conv_s8']} times for one "
             f"int8_static fast pass")
    return by_path


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on an NVIDIA GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "tubedetr_tpu_torch")):
        print("chip_smoke: the tubedetr_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from tubedetr_tpu_torch.ops import _cuda_build
    from tubedetr_tpu_torch.probes import card_line

    smi = card_line()
    print(f"[card] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    start = t0 = time.perf_counter()
    logs = _cuda_build.build_all(_cuda_build.sources())
    print(f"[build] {sorted(logs)} in {time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    k1 = phase_k1()
    k2 = phase_k2()

    workdir = os.path.join(HERE, "tubedetr_tpu_torch", "build", "smoke")
    os.makedirs(workdir, exist_ok=True)
    try:
        pipeline_launches = phase_main_path(workdir)
        phase_small_agreement(workdir)
        phase_small_int8_agreement(workdir)
        launches = phase_serve(workdir)
        flag_launches = phase_variants(workdir)
        g1, timm_launches = phase_timm(workdir, smi)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    phase_train_small()
    train_launches, train_line = phase_train(smi)
    train_bf16_launches, bf16_line = phase_train_bf16(smi, train_line)
    quant_launches = phase_train_quant(smi, bf16_line)
    cli_launches = phase_cli(smi)
    phase_cli_small()
    dist_launches, dist_tp_launches = phase_dist(smi)
    prof_launches = phase_prof(smi)
    probes = phase_probes()
    # the counts of the serving path, the HTTP server (int8_static + K2);
    # the pipeline's, the training path's and the CLI's beside them
    for entry, key in ((k1, "resize_normalize"), (k2, "fused_bottleneck")):
        entry["launches"] = launches[key]
        entry["launches_by_path"] = {"serve": launches[key],
                                     "int8_static+fused pipeline": pipeline_launches[key],
                                     "train": train_launches[key],
                                     "train bf16": train_bf16_launches[key],
                                     "model flags int8_static+fused": flag_launches[key],
                                     "cli int8 eval": cli_launches["int8_eval"][key],
                                     "cli reload request": cli_launches["reload_request"][key],
                                     **{path: n[key] for path, n in quant_launches.items()}}
    k2["launches_by_path"]["dist int8 eval (rank 0)"] = dist_launches
    k2["launches_by_path"]["dist tp int8 eval (rank 0)"] = dist_tp_launches
    # the timm legs: K1 and K2 by path beside the others', and G1's own main
    # path, the int8_static serving legs of [timm]
    for entry, key in ((k1, "resize_normalize"), (k2, "fused_bottleneck")):
        entry["launches_by_path"].update({f"timm {p}": n[key] for p, n in timm_launches.items()})
    g1["launches_by_path"] = {f"timm {p}": n["grouped_conv_s8"] for p, n in timm_launches.items()}
    # the measuring entry points of [prof]
    for entry, key in ((k1, "resize_normalize"), (k2, "fused_bottleneck"), (g1, "grouped_conv_s8")):
        entry["launches_by_path"].update(prof_launches[key])
    g1["launches"] = sum(n for p, n in g1["launches_by_path"].items() if "int8_static full" in p)
    if not g1["launches"]:
        fail("G1 was not launched on its main path, the timm int8_static serving legs")

    print(f"[time] chip_smoke.py took {time.perf_counter() - start:.1f} s", flush=True)
    print(json.dumps({"kernels": [k1, k2, g1, *probes]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
