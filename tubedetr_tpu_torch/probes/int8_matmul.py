"""P1-P3 on the card: the counterpart of ``scripts/probe_pallas_int8.py``.

    python -m tubedetr_tpu_torch.probes.int8_matmul

At K2's layer3 shapes (200 frames of 22x22 = 484 rows, K = 1024, N = 256)
it times cuBLASLt's int8 GEMM (``torch._int_mm``, the script's XLA line)
and the three hand-written products of ``ops/probe_mm.py``: the s8 GEMM over
flat rows (P1), the same in bf16 with f32 sums (P2) and the s8 GEMM tiled
frame by frame (P3). One line each: ms and TOP/s (TFLOP/s for bf16).

The script ran each for F = 2 and 8 frames a grid step and drew new data
for each F from one ``RandomState(0)``; so does this. On the card F does
not change the kernels' tiling (a block tile is 128 rows of one segment),
so the two F give two readings of the same kernels on different data.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from tubedetr_tpu_torch.ops.probe_mm import (
    bf16_mm,
    bf16_mm_plain,
    int8_mm,
    int8_mm_frames,
    int8_mm_plain,
)
from tubedetr_tpu_torch.probes import card_line, cuda_ms
from tubedetr_tpu_torch.utils.device import resolve_device

N_FRAMES, HW, K, N = 200, 484, 1024, 256
FRAMES_PER_STEP = (2, 8)


@dataclass
class Product:
    """One line of the probe: a call, its plain version (None for the
    library yardstick), and the work it does."""

    probe: str  # "P1".."P3", or "library"
    name: str
    call: Callable[[], torch.Tensor]
    plain: Optional[Callable[[], torch.Tensor]]
    ops: int
    nbytes: int  # each input read once, the output written once
    unit: str


def make_inputs(rng: np.random.RandomState, n_frames=N_FRAMES, hw=HW, k=K, n=N, device="cuda"):
    """The script's draws: ``x (n_frames*hw, k)`` then ``w (k, n)``, int8 in
    [-127, 127]; returns ``x`` and ``wt = w.T (n, k)`` on ``device``."""
    x = rng.randint(-127, 128, (n_frames * hw, k)).astype(np.int8)
    w = rng.randint(-127, 128, (k, n)).astype(np.int8)
    return torch.from_numpy(x).to(device), torch.from_numpy(w).t().contiguous().to(device)


def products(x: torch.Tensor, wt: torch.Tensor, hw: int, frames_per_step: int):
    """The probe's products on one input, in the script's order."""
    rows, k = x.shape
    n = wt.shape[0]
    ops = 2 * rows * k * n
    s8_bytes = rows * k + n * k + 4 * rows * n
    xb, wtb = x.to(torch.bfloat16), wt.to(torch.bfloat16)
    x3 = x.view(rows // hw, hw, k)
    f = frames_per_step
    return [
        Product("library", f"torch._int_mm int8 dot ({rows}x{k}x{n})",
                lambda: torch._int_mm(x, wt.t()), None, ops, s8_bytes, "TOP/s"),
        Product("P1", f"CUDA int8 dot 2D (F={f})", lambda: int8_mm(x, wt),
                lambda: int8_mm_plain(x, wt), ops, s8_bytes, "TOP/s"),
        Product("P2", f"CUDA bf16 dot 2D (F={f})", lambda: bf16_mm(xb, wtb),
                lambda: bf16_mm_plain(xb, wtb), ops, 2 * rows * k + 2 * n * k + 4 * rows * n,
                "TFLOP/s"),
        Product("P3", f"CUDA int8 dot 3D (F={f})", lambda: int8_mm_frames(x3, wt),
                lambda: int8_mm_plain(x3, wt), ops, s8_bytes, "TOP/s"),
    ]


def run(device="cuda", n_frames=N_FRAMES, hw=HW, k=K, n=N, frames_per_step=FRAMES_PER_STEP,
        seed=0, out=print):
    """Time every product for each F on the card and print its line;
    returns one record per line. On the CPU each product runs once through
    its wrapper (the plain version) and is not timed."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    records = []
    for f in frames_per_step:
        x, wt = make_inputs(rng, n_frames, hw, k, n, dev)
        for prod in products(x, wt, hw, f):
            rec = {"probe": prod.probe, "name": prod.name, "F": f, "ops": prod.ops,
                   "bytes": prod.nbytes, "unit": prod.unit}
            if dev.type == "cuda":
                rec["ms"] = cuda_ms(prod.call)
                rec["rate"] = prod.ops / rec["ms"] / 1e9
                out(f"{prod.name:34s} {rec['ms']:8.3f} ms  {rec['rate']:7.1f} {prod.unit}")
            else:
                prod.call()
                out(f"{prod.name:34s} ran on the CPU, not timed")
            records.append(rec)
        del x, wt
    return records


def main() -> int:
    resolve_device("cuda")
    print(card_line(), flush=True)
    run(out=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
