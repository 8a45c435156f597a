#!/usr/bin/env python3
"""Drive the PyTorch port (``tubedetr_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero before the last
line:

1. the card's name and power limit (``nvidia-smi``) and the CUDA version;
2. build every hand-written kernel from ``tubedetr_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together);
3. hold each kernel to its plain PyTorch version on the card at the serving
   shape, and time the kernel, the plain version and a PyTorch yardstick
   with CUDA events;
4. the main path at full width: ``GroundingPipeline`` with the bench
   headline model (ResNet-101, RoBERTa-base, res 352, T=200, stride 4, fast
   and sted on, weights from a seed) serves two requests through
   ``ground_many`` and one through ``ground``, in bfloat16 and in float32,
   with every kernel's launch count zeroed just before and read just after;
5. the same small request through the pipeline on the card and on the CPU
   (the plain path), which must agree.

Then one ``kernels`` JSON line, the ``nvidia-smi`` line again, and, last, the
``ok`` JSON line. There is no CPU path: without a card the script exits 2.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores

# K1 at the serving shape: 200 frames of 360x640 -> 330x586 at res 352
K1_SHAPE = (200, 360, 640, 3)
K1_OUT = (330, 586)
K1_CROP = (12, 20, 300, 560)
K1_FLOPS_PER_OUT = 11  # 6 for the two row lerps, 3 for the column lerp, 2 affine
F32_ATOL = 1e-4  # two f32 contractions summed in another order than the gather
SMALL_ATOL = 1e-3  # card (cuDNN, cuBLAS, no TF32) vs CPU through a whole small model


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, groups: int = 21, per_group: int = 10) -> float:
    """Median over ``groups`` of the mean CUDA-event time of ``per_group``
    back-to-back calls, after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(groups):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_group):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_group)
    return statistics.median(times)


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


def phase_k1():
    """K1 against its plain version at the serving shape; returns the
    kernels-line entry (launch count filled in after the main path)."""
    import torch
    import torch.nn.functional as F

    from tubedetr_tpu_torch.ops.preprocess import norm_affine
    from tubedetr_tpu_torch.ops.resize_normalize import resize_normalize, resize_normalize_plain

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full f32
    gen = torch.Generator().manual_seed(0)
    x = torch.randint(0, 256, K1_SHAPE, dtype=torch.uint8, generator=gen).cuda()
    n, ih, iw, _ = K1_SHAPE
    oh, ow = K1_OUT
    scale, shift = (torch.from_numpy(v).cuda() for v in norm_affine())

    def library(crop, dtype):
        src = x if crop is None else x[:, crop[0]:crop[0] + crop[2], crop[1]:crop[1] + crop[3]]
        y = F.interpolate(src.permute(0, 3, 1, 2).float(), size=(oh, ow),
                          mode="bilinear", align_corners=False)
        return (y.permute(0, 2, 3, 1) * scale + shift).to(dtype)

    cases = {}
    for name, crop, dtype in (
        ("f32", None, torch.float32),
        ("bf16", None, torch.bfloat16),
        ("crop_f32", K1_CROP, torch.float32),
    ):
        out = resize_normalize(x, oh, ow, crop=crop, out_dtype=dtype)
        ref32 = resize_normalize_plain(x, oh, ow, crop, torch.float32)
        torch.cuda.synchronize()
        if out.shape != (n, oh, ow, 3) or out.dtype != dtype:
            fail(f"K1 {name}: got {tuple(out.shape)} {out.dtype}")
        err = (out.float() - ref32).abs()
        if dtype == torch.float32:
            ok, tol = bool((err <= F32_ATOL).all()), f"atol {F32_ATOL}"
        else:  # one bf16 ulp of the f32 plain value, plus the f32 atol: near 0
            # the affine's cancellation leaves the f32 values ~1e-6 apart,
            # more than a bf16 ulp there
            ok = bool((err <= bf16_ulp(ref32) + F32_ATOL).all())
            tol = f"1 bf16 ulp + atol {F32_ATOL}"
        lib_err = (library(crop, dtype).float() - ref32).abs().max().item()
        out_bytes = n * oh * ow * 3 * out.element_size()
        bytes_ms = (x.numel() + out_bytes) / HBM_BYTES_PER_S * 1e3
        ops_ms = n * oh * ow * 3 * K1_FLOPS_PER_OUT / FP32_OPS_PER_S * 1e3
        case = {
            "max_abs_err": err.max().item(),
            "tolerance": tol,
            "ms": cuda_ms(lambda: resize_normalize(x, oh, ow, crop=crop, out_dtype=dtype)),
            "plain_ms": cuda_ms(lambda: resize_normalize_plain(x, oh, ow, crop, dtype)),
            "library_ms": cuda_ms(lambda: library(crop, dtype)),
            "library_max_abs_err": lib_err,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        }
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


def full_width_cfg(dtype: str):
    from tubedetr_tpu_torch.config import TubeDETRConfig

    # bench.py's headline model: ResNet-101, RoBERTa-base (config defaults),
    # hidden 256, 6+6 layers, 8 heads, FFN 2048
    return TubeDETRConfig(
        backbone="resnet101", resolution=352, video_max_len=200,
        video_max_len_train=200, stride=4, fast=True, sted=True,
        guided_attn=False, aux_loss=False, dropout=0.0, compute_dtype=dtype,
    )


def phase_main_path(workdir: str):
    """Full-width serving in bf16 and f32; returns the K1 launch count."""
    import numpy as np
    import torch

    from tubedetr_tpu_torch.apps.pipeline import GroundingPipeline
    from tubedetr_tpu_torch.ops.resize_normalize import resize_normalize

    rng = np.random.RandomState(0)
    paths = []
    for i in range(2):
        p = os.path.join(workdir, f"request{i}.npy")
        np.save(p, rng.randint(0, 256, K1_SHAPE, dtype=np.uint8))
        paths.append(p)
    reqs = [(paths[0], "a man in a red shirt rides a horse", -1.0, -1.0),
            (paths[1], "the dog runs across the grass", -1.0, -1.0)]

    resize_normalize.launches = 0
    served = 0
    boxes = {}
    for dtype in ("bfloat16", "float32"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pipe = GroundingPipeline(full_width_cfg(dtype))
        build_s = time.perf_counter() - t0

        _, cold_s = synced(lambda: pipe.ground_many(reqs, render=False))
        results, many_s = synced(lambda: pipe.ground_many(reqs, render=False))
        one, one_s = synced(lambda: pipe.ground(*reqs[0], render=False))
        results.append(one)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        # where a warm B=2 request goes: decode + upload + K1 + pad, the whole
        # forward (collate included), and the backbone alone inside it
        samples, prepare_s = synced(
            lambda: [pipe.prepare(*r, video_id=f"req{i}")[0] for i, r in enumerate(reqs)]
        )
        (outputs, batch), forward_s = synced(lambda: pipe.forward(samples))
        with torch.inference_mode():
            _, backbone_s = synced(lambda: pipe.model.encode_frames(
                batch["frames_fast"].flatten(0, 1), batch["fast_pad_mask"].flatten(0, 1)
            ))
        del samples, batch
        served += 2 + 2 + 1 + 2
        for r in results:
            s, e = r["sted"]
            if not (0 <= s < e <= K1_SHAPE[0]):
                fail(f"{dtype}: segment {r['sted']} outside [0, {K1_SHAPE[0]}]")
            b = np.asarray(r["boxes"])
            if b.shape != (K1_SHAPE[0], 4) or not np.isfinite(b).all():
                fail(f"{dtype}: pixel boxes {b.shape}, finite={np.isfinite(b).all()}")
        pb = outputs["pred_boxes"]
        if pb.shape != (2, K1_SHAPE[0], 4) or not np.isfinite(pb).all():
            fail(f"{dtype}: pred_boxes {pb.shape}, finite={np.isfinite(pb).all()}")
        if pb.min() < 0 or pb.max() > 1:
            fail(f"{dtype}: pred_boxes outside [0, 1]: [{pb.min()}, {pb.max()}]")
        if not np.isfinite(outputs["pred_sted"]).all():
            fail(f"{dtype}: non-finite pred_sted")
        boxes[dtype] = pb
        print(f"[main] {dtype}: " + json.dumps({
            "build_s": build_s,
            "cold_ground_many_b2_s": cold_s,
            "warm_ground_many_b2_s": many_s,
            "warm_per_request_s_b2": many_s / 2,
            "warm_ground_b1_s": one_s,
            "b2_prepare_s": prepare_s,
            "b2_forward_s": forward_s,
            "b2_backbone_s": backbone_s,
            "max_memory_allocated_gib": peak_gib,
            "segments": [r["sted"] for r in results],
        }), flush=True)
        del pipe
    launches = resize_normalize.launches
    print(f"[main] pred_boxes max |bf16 - f32| = "
          f"{float(np.abs(boxes['bfloat16'] - boxes['float32']).max())}", flush=True)
    print(f"[main] K1 launches {launches} for {served} requests prepared", flush=True)
    if launches != served:
        fail(f"K1 launched {launches} times for {served} requests prepared")
    return launches


def phase_small_agreement(workdir: str):
    """One small request through the pipeline on the card and on the CPU."""
    import numpy as np

    from tubedetr_tpu_torch.apps.pipeline import GroundingPipeline
    from tubedetr_tpu_torch.config import TubeDETRConfig

    cfg = TubeDETRConfig(
        backbone="resnet14", hidden_dim=32, nheads=4, enc_layers=1, dec_layers=2,
        dim_feedforward=64, video_max_len=8, video_max_len_train=8, stride=2,
        resolution=128, max_text_len=8, text_vocab_size=128, text_hidden_size=32,
        text_layers=1, text_heads=4, text_ffn=64, text_max_positions=40,
        guided_attn=False, aux_loss=False, dropout=0.0,
    )
    path = os.path.join(workdir, "small.npy")
    np.save(path, np.random.RandomState(1).randint(0, 256, (7, 96, 160, 3), dtype=np.uint8))
    outs = {}
    for dev in ("cuda", "cpu"):
        pipe = GroundingPipeline(cfg, device=dev)
        outs[dev] = pipe.forward([pipe.prepare(path, "a red square", -1, -1, "v")[0]])[0]
    for k in ("pred_boxes", "pred_sted", "weights", "ca_weights"):
        d = float(np.abs(outs["cuda"][k] - outs["cpu"][k]).max())
        print(f"[small] {k}: max |card - cpu| = {d} (atol {SMALL_ATOL})", flush=True)
        if not d <= SMALL_ATOL:
            fail(f"small request: {k} differs between card and CPU by {d}")


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

    smi = smi_line()
    print(f"[card] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    t0 = time.perf_counter()
    logs = _cuda_build.build_all(_cuda_build.sources())
    print(f"[build] {sorted(logs)} in {time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    k1 = phase_k1()

    workdir = os.path.join(HERE, "tubedetr_tpu_torch", "build", "smoke")
    os.makedirs(workdir, exist_ok=True)
    try:
        k1["launches"] = phase_main_path(workdir)
        phase_small_agreement(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    print(json.dumps({"kernels": [k1]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
