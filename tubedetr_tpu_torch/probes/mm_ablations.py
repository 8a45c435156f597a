"""Ablations of P1-P3's GEMM kernel on the card: what each stream of its
traffic costs.

    python -m tubedetr_tpu_torch.probes.mm_ablations [name ...]

Each ablation is ``csrc/probe_mm.cu`` (with ``csrc/wgmma_tiles.cuh``) under
one textual edit, built with the port's ``nvcc`` flags into
``build/ablations/<name>/``:

* ``base``: the kernel as it is;
* ``no_b``: B is never loaded, each stage waits for A's 16 KB only: what
  B's re-reads from L2 cost (wrong sums);
* ``half_b``: B is loaded on every other 128-byte slice of K, the L2 traffic
  a 2-block cluster multicasting B would leave (wrong sums);
* ``no_store``: the epilogue's stores are predicated off: the read side
  alone (no output);
* ``stream_store``: the stores carry the evict-first hint (``__stcs``);
* ``l2_hints``: TMA loads with L2 hints, A evict-first and B evict-last.

At the probe's shapes (96800 x 1024 by 1024 x 256) each ablation runs P1, P3
(tiled by 484-row frame) and P2 (bf16) through the C entries into
preallocated outputs, in turns with the others (six rounds, alternating
order, each the CUDA-event mean of 20 launches) beside ``torch._int_mm`` and
``torch.mm`` (bf16 in, f32 out). It prints the card's name and power limit,
whether each ablation's sums equal the plain version's, the median ms of
each, and the host microseconds of the wrapper's parts (``torch.empty``, the
device context, the stream, the checks, ctypes with the launch, and the
whole ``int8_mm``). Without a card it raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from tubedetr_tpu_torch.ops import _cuda_build, probe_mm
from tubedetr_tpu_torch.probes import card_line
from tubedetr_tpu_torch.probes.int8_matmul import HW, K, N, N_FRAMES
from tubedetr_tpu_torch.utils.device import resolve_device

_TMA_2D = (
    "                                            int c0, int c1) {\n"
    "  asm volatile(\n"
    '      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"\n'
    '      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),\n'
    '      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)'
)
_TMA_3D = (
    "                                            int c0, int c1, int c2) {\n"
    "  asm volatile(\n"
    '      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"\n'
    '      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),\n'
    '      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)'
)
_EVICT_NORMAL, _EVICT_FIRST, _EVICT_LAST = (
    "0x1000000000000000ull", "0x12F0000000000000ull", "0x14F0000000000000ull")
_LOAD_B = "tma_load_2d(ring_b + stage * kBBytes, bmap, &full[stage], kc, t.n0);"


def _with_l2_hint(load: str, coord: str, operand: int) -> str:
    """A TMA load of ``wgmma_tiles.cuh`` given an L2 cache-policy argument
    (evict-normal by default) after its last coordinate ``coord``."""
    return (load.replace(f"int {coord}) {{", f"int {coord}, uint64_t pol = {_EVICT_NORMAL}) {{")
            .replace('bytes"', 'bytes.L2::cache_hint"')
            .replace('[%2];"', f'[%2], %{operand};"')
            .replace(f'"r"({coord})', f'"r"({coord}), "l"(pol)'))


_EXPECT = "mbar_arrive_expect_tx(&full[stage], kStageBytes);"

# name -> [(file, text, replacement)]
ABLATIONS = {
    "base": [],
    "no_b": [("probe_mm.cu", _EXPECT, "mbar_arrive_expect_tx(&full[stage], kABytes);"),
             ("probe_mm.cu", _LOAD_B, "(void)bmap;")],
    "half_b": [("probe_mm.cu", _EXPECT,
                "mbar_arrive_expect_tx(&full[stage], (kb & 1) ? kABytes : kStageBytes);"),
               ("probe_mm.cu", _LOAD_B, "if (!(kb & 1)) " + _LOAD_B)],
    "no_store": [("probe_mm.cu", "if (t.n0 + 8 * j < s.n) store2(",
                  "if (t.n0 + 8 * j < s.n && s.n < 0) store2(")],
    "stream_store": [
        ("probe_mm.cu", "*reinterpret_cast<int2*>(p) = make_int2(a, b);",
         "__stcs(reinterpret_cast<int2*>(p), make_int2(a, b));"),
        ("probe_mm.cu", "*reinterpret_cast<float2*>(p) = make_float2(a, b);",
         "__stcs(reinterpret_cast<float2*>(p), make_float2(a, b));")],
    "l2_hints": [
        ("wgmma_tiles.cuh", _TMA_2D, _with_l2_hint(_TMA_2D, "c1", 5)),
        ("wgmma_tiles.cuh", _TMA_3D, _with_l2_hint(_TMA_3D, "c2", 6)),
        ("probe_mm.cu", "kc, t.r0, t.seg);", f"kc, t.r0, t.seg, {_EVICT_FIRST});"),
        ("probe_mm.cu", "kc, t.r0);", f"kc, t.r0, {_EVICT_FIRST});"),
        ("probe_mm.cu", "kc, t.n0);", f"kc, t.n0, {_EVICT_LAST});")],
}
WRONG_SUMS = {"no_b", "half_b", "no_store"}  # ablations that drop work on purpose


def sources(name: str) -> dict:
    """{file name: text} of ``probe_mm.cu`` and the headers under ablation
    ``name``; raises if an edit no longer applies to the sources."""
    files = {f: open(os.path.join(_cuda_build.CSRC, f)).read()
             for f in os.listdir(_cuda_build.CSRC) if f == "probe_mm.cu" or f.endswith(".cuh")}
    for f, text, new in ABLATIONS[name]:
        if files[f].count(text) != 1:
            raise RuntimeError(f"ablation {name} no longer applies to {f}: {text[:60]!r}")
        files[f] = files[f].replace(text, new)
    return files


def build(names):
    """Build each ablation's library in parallel; returns {name: CDLL}."""
    procs = {}
    for name in names:
        d = os.path.join(_cuda_build.BUILD, "ablations", name)
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        for f, text in sources(name).items():
            with open(os.path.join(d, f), "w") as fh:
                fh.write(text)
        lib = os.path.join(d, "libprobe_mm.so")
        procs[name] = (lib, subprocess.Popen(
            _cuda_build.nvcc_command(os.path.join(d, "probe_mm.cu"), lib),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for ablation {name}:\n{log}")
        libs[name] = ctypes.CDLL(lib)
        for entry in ("probe_mm_s8", "probe_mm_bf16"):
            fn = getattr(libs[name], entry)
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return libs


def _events_ms(fn, launches=20):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def _host_us(fn, calls=100, rounds=10):
    """Median over rounds of the host time of ``calls`` enqueues, no
    synchronize between them."""
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def run(names=tuple(ABLATIONS), seed=0, rounds=6, out=print):
    """Build, check and time the ablations (``base`` first: the host parts
    time it); returns {(name, probe): median ms} and {wrapper part: host
    us}."""
    dev = resolve_device("cuda")
    libs = build(names)
    rng = np.random.RandomState(seed)
    rows = N_FRAMES * HW
    x = torch.from_numpy(rng.randint(-127, 128, (rows, K)).astype(np.int8)).to(dev)
    wt = torch.from_numpy(rng.randint(-127, 128, (K, N)).astype(np.int8)).t().contiguous().to(dev)
    xb, wtb = x.bfloat16(), wt.bfloat16()
    refs = {"P1": probe_mm.int8_mm_plain(x, wt), "P2": probe_mm.bf16_mm_plain(xb, wtb)}
    refs["P3"] = refs["P1"]
    outs = {"P1": torch.empty(rows, N, dtype=torch.int32, device=dev),
            "P2": torch.empty(rows, N, dtype=torch.float32, device=dev)}
    outs["P3"] = outs["P1"]
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(lib, probe):
        if probe == "P2":
            args = (xb, wtb, outs["P2"], rows, N, K, rows)
            fn = lib.probe_mm_bf16
        else:
            args = (x, wt, outs[probe], rows, N, K, HW if probe == "P3" else rows)
            fn = lib.probe_mm_s8
        err = fn(args[0].data_ptr(), args[1].data_ptr(), args[2].data_ptr(), *args[3:], stream)
        if err:
            raise RuntimeError(f"probe_mm ablation launch failed: CUDA error {err}")

    out(card_line())
    probes = ("P1", "P3", "P2")
    for name, lib in libs.items():
        for probe in probes:
            outs[probe].zero_()
            call(lib, probe)
            same = torch.equal(outs[probe], refs[probe])
            note = " (drops work on purpose)" if name in WRONG_SUMS else ""
            verdict = "equals" if same else "differs from"
            out(f"{name:13s} {probe}: {verdict} the plain version{note}")
    times = {}
    library = {"P1": lambda: torch._int_mm(x, wt.t()),
               "P2": lambda: torch.mm(xb, wtb.t(), out_dtype=torch.float32)}
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            for probe in probes:
                call(libs[name], probe)  # warm
                times.setdefault((name, probe), []).append(
                    _events_ms(lambda: call(libs[name], probe)))
        for probe, fn in library.items():
            fn()
            times.setdefault(("library", probe), []).append(_events_ms(fn))
    medians = {key: statistics.median(v) for key, v in times.items()}
    for (name, probe), ms in medians.items():
        rounds_ms = ", ".join(f"{t:.4f}" for t in times[name, probe])
        out(f"{name:13s} {probe}: {ms:.5f} ms (rounds: {rounds_ms})")

    x3 = x.view(N_FRAMES, HW, K)

    def device_ctx():
        with torch.cuda.device(x.device):
            pass

    base_s8 = libs[names[0]].probe_mm_s8
    parts = {
        "torch.empty of the output": lambda: torch.empty(rows, N, dtype=torch.int32, device=dev),
        "torch.cuda.device context": device_ctx,
        "current_stream(device).cuda_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "the wrapper's checks": lambda: probe_mm._check(x, wt, torch.int8, 2),
        "ctypes call, nothing launched": lambda: base_s8(
            x.data_ptr(), wt.data_ptr(), outs["P1"].data_ptr(), 0, N, K, rows, stream),
        "ctypes call with two map encodes and the launch": lambda: call(libs[names[0]], "P1"),
        "int8_mm (P1), whole": lambda: probe_mm.int8_mm(x, wt),
        "int8_mm_frames (P3), whole": lambda: probe_mm.int8_mm_frames(x3, wt),
        "torch._int_mm, whole": library["P1"],
    }
    host = {}
    for part, fn in parts.items():
        fn()
        host[part] = _host_us(fn)
        out(f"host {part}: {host[part]:.2f} us a call")
    return medians, host


def main(argv=None) -> int:
    names = tuple(argv if argv is not None else sys.argv[1:]) or tuple(ABLATIONS)
    unknown = [n for n in names if n not in ABLATIONS]
    if unknown:
        raise SystemExit(f"unknown ablations {unknown}; choose from {list(ABLATIONS)}")
    names = ("base",) + tuple(n for n in names if n != "base")
    run(names, out=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
