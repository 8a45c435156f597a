"""Host staging throughput: the counterpart of ``scripts/bench_staging.py``.

    python -m tubedetr_tpu_torch.probes.staging

Frames a second through ``data/native.py:resize_normalize_clip`` (the data
workers' path: uint8 frames -> the sparse separable resize -> /255 and the
ImageNet normalization, float32) for a 200-frame 360x640 clip resized to
352x352: the host library ``native/staging.cc`` on its worker pool (a
thread a core) against its numpy version (``plain=True``), each the best
of ``ITERS`` (3) after a warm call.

The script set those rates beside the demand of a training step and an
inference call measured on a TPU. Those are not this card's numbers, so
the demand side comes only from readings taken on the card in the same
run: ``run(demand={"name": seconds a 200-frame clip})`` prints the cores
each needs to keep up. ``main`` takes one such reading first, the port's
whole training step at the script's config (``probes.train_step``, one
step after a cold one), so it needs the card and raises without one;
``chip_smoke.py``'s ``[prof]`` phase passes its own train-step and trunk
times.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, Optional

import numpy as np

from tubedetr_tpu_torch.data import native
from tubedetr_tpu_torch.ops.preprocess import _interp_matrix
from tubedetr_tpu_torch.probes import card_line, train_step
from tubedetr_tpu_torch.utils.device import resolve_device

T, IH, IW, RES = 200, 360, 640, 352


def best_s(fn, iters: int) -> float:
    fn()  # warm: builds the library and its pool at first use
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def run(t: int = T, ih: int = IH, iw: int = IW, res: int = RES, iters: int = 3, seed: int = 0,
        demand: Optional[Dict[str, float]] = None, out=print) -> dict:
    """Frames a second of the native pool and of the numpy version, and the
    cores each entry of ``demand`` needs at the native rate a core."""
    clip = np.random.RandomState(seed).randint(0, 256, (t, ih, iw, 3), dtype=np.uint8)
    ah, aw = _interp_matrix(ih, res), _interp_matrix(iw, res)
    cores = os.cpu_count() or 1
    rec = {"frames": t, "cores": cores}
    for name, plain in (("native CSR pool", False), ("numpy einsum", True)):
        s = best_s(lambda: native.resize_normalize_clip(clip, ah, aw, plain=plain), iters)
        rec["plain" if plain else "native"] = {"ms_per_clip": s * 1e3, "frames_per_s": t / s}
        out(f"{name:18s} {s * 1e3:8.1f} ms/clip  {t / s:7.0f} frames/s")
    fps_core = rec["native"]["frames_per_s"] / cores
    rec["cores_to_overlap"] = {}
    for name, clip_s in (demand or {}).items():
        need = t / clip_s / fps_core
        rec["cores_to_overlap"][name] = need
        out(f"cores to overlap {name}: {need:.1f} (at {rec['native']['frames_per_s']:.0f} "
            f"frames/s on {cores} core(s))")
    return rec


def main() -> int:
    resolve_device("cuda")
    print(card_line(), flush=True)
    step = train_step.profile(train_step.make_config(), k=1, iters=1, names=("full",),
                              out=lambda line: print(line, file=sys.stderr, flush=True))
    run(iters=int(os.environ.get("ITERS", 3)),
        demand={"the train step (this card, this run)": step["ms"]["full"] / 1e3},
        out=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
