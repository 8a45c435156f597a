"""P4 and P5 on the card: the counterpart of ``scripts/probe_fused_variants.py``.

    python -m tubedetr_tpu_torch.probes.fused_variants [full:2 noshift:2 hwpad:2 ...]

Each spec is ``variant:F``, the script's; with none it runs the script's
default list. At K2's layer3 tail shapes (N = 200 frames of 22x22, C = 1024,
P = 256; a = 1e-4, b = 0, residual ``x * 0.01``):

* ``full``, ``noshift``, ``convonly`` (P4): K2's own kernel, whole, without
  the halo and shifted taps, and without the 3x3 (``ops/probe_bottleneck.py``);
* ``dot2d``: on the TPU the 3D dot split into per-frame 2D dots, a question
  of Mosaic's lowering; K2 runs on bands of its padded grid whatever the
  frames are, so it runs ``full``'s kernel;
* ``hwpad``, ``im2col`` (P5): the same function on frames padded to 512
  rows, by K2's kernel in its flat layout: nine shifted products, or one
  K=9P product over a patch copied a slice at a time.

F (frames a TPU grid step) has no counterpart on the card: a block walks
bands of grid positions whatever F is. It is accepted and printed. One line per spec: ms and TOP/s over the script's
operation count (the whole block's, for every variant, on the 484 real
rows); a spec whose kernel already ran in this call names that spec as
``same_kernel_as``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tubedetr_tpu_torch.ops.probe_bottleneck import (
    FLAT_VARIANTS,
    bottleneck_variant,
    bottleneck_variant_plain,
    flat_bottleneck,
    flat_bottleneck_plain,
    probe_fold,
)
from tubedetr_tpu_torch.probes import card_line, cuda_ms
from tubedetr_tpu_torch.utils.device import resolve_device

N, H, W, C, P = 200, 22, 22, 1024, 256
HWP = 512
DEFAULT_SPECS = ("full:2", "noshift:2", "dot2d:2", "convonly:2", "noshift:8")
KERNEL = {  # spec variant -> the kernel it runs
    "full": "full", "dot2d": "full", "noshift": "noshift", "convonly": "convonly",
    "hwpad": "hwpad", "im2col": "im2col",
}


def parse_spec(spec: str):
    """``"variant:F"`` -> ``(variant, F)``."""
    variant, sep, f = spec.partition(":")
    if not sep or variant not in KERNEL or not f.isdigit() or int(f) < 1:
        raise ValueError(f"a spec is variant:F with variant in {sorted(KERNEL)}; got {spec!r}")
    return variant, int(f)


def block_ops(n=N, h=H, w=W, c=C, p=P) -> int:
    """The script's operation count: the whole block on the real rows."""
    return 2 * n * h * w * (c * p + 9 * p * p + p * c)


def make_inputs(flat: bool, n=N, h=H, w=W, c=C, p=P, hwp=HWP, seed=0, device="cuda"):
    """The script's draws from ``RandomState(seed)``: the stream ``(n, hwp
    if flat else h*w, c)``, then ``w1 (c, p)``, ``w2 (9, p, p)``, ``w3 (p, c)``,
    int8 in [-127, 127]; returns the stream and the probe's fold on
    ``device``."""
    rng = np.random.RandomState(seed)
    x = rng.randint(-127, 128, (n, hwp if flat else h * w, c)).astype(np.int8)
    ws = [rng.randint(-127, 128, s).astype(np.int8) for s in ((c, p), (9, p, p), (p, c))]
    fold = probe_fold(*(torch.from_numpy(v).to(device) for v in ws))
    return torch.from_numpy(x).to(device), fold


def variant_call(variant: str, x: torch.Tensor, fold, h=H, w=W):
    """``() -> out``: the spec's kernel on the card (its plain version for a
    CPU stream), output shaped as ``x``."""
    if variant in FLAT_VARIANTS:
        return lambda: flat_bottleneck(x, fold, variant, h, w)
    x4 = x.view(x.shape[0], h, w, x.shape[-1])
    return lambda: bottleneck_variant(x4, fold, KERNEL[variant]).view(x.shape)


def plain_call(variant: str, x: torch.Tensor, fold, h=H, w=W):
    """``() -> out``: the spec's plain version, output shaped as ``x``."""
    if variant in FLAT_VARIANTS:
        return lambda: flat_bottleneck_plain(x, fold, h, w)
    x4 = x.view(x.shape[0], h, w, x.shape[-1])
    return lambda: bottleneck_variant_plain(x4, fold, KERNEL[variant]).view(x.shape)


def run(specs=DEFAULT_SPECS, device="cuda", n=N, h=H, w=W, c=C, p=P, hwp=HWP, seed=0, out=print):
    """Time each spec on the card and print its line; returns one record per
    spec. On the CPU each spec runs once (the plain versions), untimed."""
    dev = resolve_device(device)
    parsed = [(spec, *parse_spec(spec)) for spec in specs]
    inputs = {}  # every spec re-seeds, as the script's run does: one draw per layout
    first_of = {}
    ops = block_ops(n, h, w, c, p)
    records = []
    for spec, variant, f in parsed:
        flat = variant in FLAT_VARIANTS
        if flat not in inputs:
            inputs[flat] = make_inputs(flat, n, h, w, c, p, hwp, seed, dev)
        call = variant_call(variant, *inputs[flat], h, w)
        kernel = KERNEL[variant]
        rec = {"spec": spec, "variant": variant, "F": f, "kernel": kernel, "ops": ops,
               "same_kernel_as": first_of.get(kernel)}
        first_of.setdefault(kernel, spec)
        same = f"  same_kernel_as={rec['same_kernel_as']}" if rec["same_kernel_as"] else ""
        if dev.type == "cuda":
            rec["ms"] = cuda_ms(call)
            rec["tops"] = ops / rec["ms"] / 1e9
            out(f"{variant:9s} F={f}: {rec['ms']:8.3f} ms  {rec['tops']:6.1f} TOP/s{same}")
        else:
            call()
            out(f"{variant:9s} F={f}: ran on the CPU, not timed{same}")
        records.append(rec)
    return records


def main(argv=None) -> int:
    specs = list(argv if argv is not None else sys.argv[1:]) or list(DEFAULT_SPECS)
    for spec in specs:
        parse_spec(spec)
    resolve_device("cuda")
    print(card_line(), flush=True)
    run(specs, out=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
