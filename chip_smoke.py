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
   (resize+normalize) at the serving shape, K2 (the fused int8 bottleneck)
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
   plain path), float and int8_static + fused, which must agree;
6. the probes P1-P5 (``tubedetr_tpu_torch/probes``): both entry points at
   the scripts' full shapes with their launch counts zeroed just before and
   read just after, each kernel held exactly to its plain version, and
   noshift and convonly timed beside K2 at layer3's serving shape. They run
   after the serving phases so that their GBs of inputs cannot move those.
   For P1-P3 the entries also carry the kernel's registers, spills and
   shared memory (its build log; a spill or an ignored ``setmaxnreg``
   fails) and the wrapper's host microseconds a call.

Then one ``kernels`` JSON line, the ``nvidia-smi`` line again, and, last, the
``ok`` JSON line. There is no CPU path: without a card the script exits 2.
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

# P1-P5, the probes: the scripts' default specs plus both flat variants, at
# the scripts' full shapes; noshift and convonly again beside K2 at layer3's
# serving shape (seed 22: K2's own layer3 input in phase_k2)
PROBE_SPECS = ("full:2", "noshift:2", "dot2d:2", "convonly:2", "noshift:8", "hwpad:2", "im2col:2")
PROBE_SERVING = K2_STAGES["layer3"][:5]
PROBE_SERVING_SEED = 22


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


def phase_k1():
    """K1 against its plain version at the serving shape; returns the
    kernels-line entry (launch count filled in after the main path)."""
    import torch
    import torch.nn.functional as F

    from tubedetr_tpu_torch.ops.preprocess import norm_affine
    from tubedetr_tpu_torch.ops.resize_normalize import resize_normalize, resize_normalize_plain
    from tubedetr_tpu_torch.probes import cuda_ms

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
    usage = k2_usage()
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
    """K2's kernel for each P it is built for (the ``kFull`` instantiation,
    which the probe's ``noshift`` runs too; ``convonly`` has its own), from
    ``build_usage``: fails unless there are 4 P x 2 entries."""
    import re

    usage = build_usage("fused_bottleneck")
    out, seen = {}, []
    for name, u in usage.items():
        m = re.search(r"fused_bottleneck_kernelILi(\d+)E.*VariantE(\d)E", name)
        if m:
            seen.append(name)
            if m.group(2) == "0":
                out[int(m.group(1))] = entry_usage(u)
    if len(seen) != 8 or sorted(out) != [64, 128, 256, 512]:
        fail(f"fused_bottleneck: expected 8 kernel entries (4 P x full, convonly) in its build "
             f"log, found {list(usage)}")
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
    from tubedetr_tpu_torch.ops.fused_bottleneck import fused_bottleneck_block
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
    bv_cases, flat_cases = {}, {}
    for flat, cases in ((False, bv_cases), (True, flat_cases)):
        x, fold = fv.make_inputs(flat)
        small = {dev: fv.make_inputs(flat, n=2, device=dev) for dev in ("cpu", "cuda")}
        outs = {}
        variants = dict.fromkeys(fv.parse_spec(spec)[0] for spec in PROBE_SPECS)
        for variant in (v for v in variants if (v in pb.FLAT_VARIANTS) == flat):
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
        "probe_flat_bottleneck", "tubedetr_tpu_torch/csrc/probe_flat_bottleneck.cu",
        "scripts/probe_fused_variants.py:237", flat_cases, "hwpad", None))
    for entry, key in zip(entries, ("P1", "P2", "P3", "P4", "P5")):
        entry["launches"] = launches[key]
        entry["probe"] = key
    return entries


def full_width_cfg(dtype: str, **extra):
    from tubedetr_tpu_torch.config import TubeDETRConfig

    # bench.py's headline model: ResNet-101, RoBERTa-base (config defaults),
    # hidden 256, 6+6 layers, 8 heads, FFN 2048
    return TubeDETRConfig(
        backbone="resnet101", resolution=352, video_max_len=200,
        video_max_len_train=200, stride=4, fast=True, sted=True,
        guided_attn=False, aux_loss=False, dropout=0.0, compute_dtype=dtype, **extra,
    )


def check_results(label, results, outputs):
    import numpy as np

    for r in results:
        s, e = r["sted"]
        if not (0 <= s < e <= K1_SHAPE[0]):
            fail(f"{label}: segment {r['sted']} outside [0, {K1_SHAPE[0]}]")
        b = np.asarray(r["boxes"])
        if b.shape != (K1_SHAPE[0], 4) or not np.isfinite(b).all():
            fail(f"{label}: pixel boxes {b.shape}, finite={np.isfinite(b).all()}")
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
    and the boxes and sted logits against ``SMALL_INT8_ATOL``."""
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

    t0 = time.perf_counter()
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
        launches = phase_main_path(workdir)
        phase_small_agreement(workdir)
        phase_small_int8_agreement(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    probes = phase_probes()
    # the counts of this slice's path: int8_static + K2 serving
    k1["launches"] = launches["resize_normalize"]
    k2["launches"] = launches["fused_bottleneck"]

    print(json.dumps({"kernels": [k1, k2, *probes]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
