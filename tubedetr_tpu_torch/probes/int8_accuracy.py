"""int8_static against float at full width on the card: the counterpart of ``scripts/check_int8_accuracy.py``.

    python -m tubedetr_tpu_torch.probes.int8_accuracy
    FUSED=1 T=200 RES=352 python -m tubedetr_tpu_torch.probes.int8_accuracy

The flagship config (ResNet-101, stride 4, resolution ``RES`` (352), ``T``
frames (200), batch 1, bf16 compute, the fast branch, sted, no aux outputs,
dropout 0) runs twice on the same weights and input: once with the float
trunk, once in int8_static, calibrated first through the int8 observer twin
(``models/quantize.py:calibrate_qscales``). ``FUSED=1`` sets the config's
``fused_bottleneck``, so K2 runs the int8 trunk's stride-1 tails, as on the
serving path. It prints the script's two lines: the boxes' largest and
mean deviation and their correlation, and the sted logits' deviations and
the (start, end) argmax of each run.

The weights follow the script's rule by leaf name (``fabricate``): running
variances 1, running means 0, norm scales and 1-D weights 1, biases 0, and
everything else ``N(0, 0.02^2)`` rounded to bf16 (stored float32). The rule
is applied to the port's own ``state_dict``, so the draw differs from the
JAX one. They are not trained weights: the deviations say how much noise
the int8 trunk adds, not what it costs in vIoU.
"""

from __future__ import annotations

import os
import sys
from typing import Dict

import numpy as np
import torch

from tubedetr_tpu_torch.config import TubeDETRConfig
from tubedetr_tpu_torch.models.quantize import calibrate_qscales
from tubedetr_tpu_torch.models.tubedetr import build_model
from tubedetr_tpu_torch.ops.fused_bottleneck import fused_bottleneck_block
from tubedetr_tpu_torch.probes import card_line
from tubedetr_tpu_torch.utils.device import resolve_device


def make_config(t: int = 200, res: int = 352, **extra) -> TubeDETRConfig:
    """The script's float config (``extra`` overrides any field)."""
    kw = dict(backbone="resnet101", stride=4, resolution=res, video_max_len=t,
              video_max_len_train=t, compute_dtype="bfloat16", fast=True, guided_attn=False,
              sted=True, aux_loss=False, dropout=0.0)
    kw.update(extra)
    return TubeDETRConfig(**kw).validate()


def fabricate(model: torch.nn.Module, seed: int = 0) -> Dict[str, torch.Tensor]:
    """The script's weights by leaf name over ``model``'s ``state_dict``."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, t in model.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "running_mean" or leaf.endswith("bias"):
            v = torch.zeros(t.shape)
        elif leaf == "running_var" or (leaf == "weight" and t.dim() == 1):
            v = torch.ones(t.shape)
        else:
            v = torch.from_numpy(rng.randn(*t.shape) * 0.02).to(torch.bfloat16).float()
        out[name] = v
    return out


def make_batch(cfg: TubeDETRConfig, rng: np.random.RandomState) -> Dict[str, torch.Tensor]:
    """The script's input: bf16 normal frames for both streams, 12 real
    tokens, the full duration, no pad."""
    t, res, length = cfg.video_max_len, cfg.resolution, cfg.max_text_len
    tc = -(-t // cfg.stride)
    bf16 = torch.bfloat16
    return {
        "frames_slow": torch.from_numpy(rng.randn(1, tc, res, res, 3).astype(np.float32)).to(bf16),
        "slow_pad_mask": torch.zeros((1, tc, res, res), dtype=torch.bool),
        "tokens": torch.from_numpy(rng.randint(4, cfg.text_vocab_size, (1, length))),
        "text_pad_mask": torch.arange(length)[None] >= 12,
        "durations": torch.full((1,), t, dtype=torch.int64),
        "frames_fast": torch.from_numpy(rng.randn(1, t, res, res, 3).astype(np.float32)).to(bf16),
        "fast_pad_mask": torch.zeros((1, t, res, res), dtype=torch.bool),
    }


def deviations(out_f: Dict, out_q: Dict) -> dict:
    """The script's readings of two forwards' outputs."""
    bf, bq = (o["pred_boxes"].double().cpu().numpy() for o in (out_f, out_q))
    sf, sq = (o["pred_sted"].double().cpu().numpy() for o in (out_f, out_q))
    db, ds = np.abs(bq - bf), np.abs(sq - sf)
    return {"boxes_max_dev": float(db.max()), "boxes_mean_dev": float(db.mean()),
            "boxes_corr": float(np.corrcoef(bf.ravel(), bq.ravel())[0, 1]),
            "sted_max_dev": float(ds.max()), "sted_mean_dev": float(ds.mean()),
            "argmax_f32": sf[0].argmax(axis=0).tolist(),
            "argmax_int8": sq[0].argmax(axis=0).tolist()}


def compare(model_f, model_q, inputs: Dict):
    """(float outputs, int8_static outputs, K2 launches of the int8
    forward), ``model_q`` on the scales its observers hold."""
    with torch.inference_mode():
        out_f = model_f(**inputs)
        before = fused_bottleneck_block.launches
        out_q = model_q(**inputs)
        launches = fused_bottleneck_block.launches - before
    return out_f, out_q, launches


def run(t: int = 200, res: int = 352, fused: bool = False, device="cuda", seed: int = 0,
        out=print) -> dict:
    """Both forwards of the flagship config; returns the readings and K2's
    launches in the int8 forward (one trunk pass)."""
    dev = resolve_device(device)
    cfg = make_config(t, res)
    cfg_q = cfg.replace(backbone_quant="int8_static", fused_bottleneck=fused)
    model_f = build_model(cfg, device=dev)
    weights = fabricate(model_f, seed)
    model_f.load_state_dict(weights)
    model_q = build_model(cfg_q, device=dev)
    model_q.load_state_dict(weights)
    inputs = {k: v.to(dev) for k, v in make_batch(cfg, np.random.RandomState(seed)).items()}
    calibrate_qscales(cfg_q, model_q, inputs)
    out_f, out_q, launches = compare(model_f, model_q, inputs)
    rec = {**deviations(out_f, out_q), "fused": fused, "k2_launches": launches}
    out(f"pred_boxes (cxcywh in [0,1]): max dev {rec['boxes_max_dev']:.4f}, mean dev "
        f"{rec['boxes_mean_dev']:.5f}, corr {rec['boxes_corr']:.5f}")
    out(f"pred_sted logits: max dev {rec['sted_max_dev']:.4f}, mean {rec['sted_mean_dev']:.5f}, "
        f"argmax(start,end) f32={rec['argmax_f32']} int8={rec['argmax_int8']}")
    return rec


def main() -> int:
    resolve_device("cuda")
    print(card_line(), flush=True)
    env = os.environ.get
    run(t=int(env("T", 200)), res=int(env("RES", 352)), fused=env("FUSED", "0") == "1",
        out=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
