"""RegNetX/Y 002-032 trunks with timm's names (counterpart of ``tubedetr_tpu/models/regnet.py``).

timm's RegNet (timm 0.4.12 layout): a 3x3/s2 stem of 32 channels
(``stem.conv`` -> ``stem.bn`` -> ReLU), then stages ``s1..s4`` of blocks
``b1..bN``, each a bottleneck of ratio 1: ``conv1`` 1x1 -> BN -> ReLU,
``conv2`` 3x3 grouped (stride 2 in a stage's first block) -> BN -> ReLU,
RegNetY's ``se`` (``fc1`` -> ReLU -> ``fc2`` -> sigmoid gate, reduced from
the block's input channels), ``conv3`` 1x1 -> BN, a ``downsample`` conv + BN
where the stride or the width changes, and ReLU after the residual add.
Names: ``stem.{conv,bn}``, ``s{i}.b{j}.conv{1,2,3}.{conv,bn}``,
``s{i}.b{j}.se.fc{1,2}``, ``s{i}.b{j}.downsample.{conv,bn}``.

Widths follow the RegNet paper's quantized linear rule (``stage_plan``).
The quantized modes run ``conv1``, ``conv2`` (G1, a grouped conv),
``conv3`` and the downsample int8 (``models/timm.py``); the stem and the SE
projections stay float.
"""

from __future__ import annotations

import itertools
import math
from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from tubedetr_tpu_torch.models.resnet import FrozenBatchNorm2d, QConv
from tubedetr_tpu_torch.models.timm import SqueezeExcite, TimmTrunk

# name -> (wa, w0, wm, depth, group_width, se_ratio)
REGNET_CFGS = {
    "regnetx_002": (36.44, 24, 2.49, 13, 8, 0.0),
    "regnetx_004": (24.48, 24, 2.54, 22, 16, 0.0),
    "regnetx_006": (36.97, 48, 2.24, 16, 24, 0.0),
    "regnetx_008": (35.73, 56, 2.28, 16, 16, 0.0),
    "regnetx_016": (34.01, 80, 2.25, 18, 24, 0.0),
    "regnetx_032": (26.31, 88, 2.25, 25, 48, 0.0),
    "regnety_002": (36.44, 24, 2.49, 13, 8, 0.25),
    "regnety_004": (27.89, 48, 2.09, 16, 8, 0.25),
    "regnety_006": (32.54, 48, 2.32, 15, 16, 0.25),
    "regnety_008": (38.84, 56, 2.4, 14, 16, 0.25),
    "regnety_016": (20.71, 48, 2.65, 27, 24, 0.25),
    "regnety_032": (42.63, 80, 2.66, 21, 24, 0.25),
}

STEM_CH = 32


def generate_widths(wa: float, w0: int, wm: float, depth: int, q: int = 8) -> List[int]:
    """Per-block widths from the paper's quantized linear rule."""
    widths = []
    for j in range(depth):
        u = w0 + wa * j
        e = round(math.log(u / w0) / math.log(wm))
        widths.append(int(round(w0 * wm ** e / q) * q))
    return widths


def stage_plan(name: str) -> List[Tuple[int, int, int, float]]:
    """Per-stage (width, depth, group width, se ratio), each width rounded
    to a multiple of its group width."""
    wa, w0, wm, depth, group, se = REGNET_CFGS[name]
    plan = []
    for w, grp in itertools.groupby(generate_widths(wa, w0, wm, depth)):
        d = len(list(grp))
        gw = min(group, w)
        plan.append((int(round(w / gw) * gw), d, gw, se))
    if len(plan) != 4:
        raise ValueError(f"{name}: {len(plan)} stages, every published X/Y model has 4")
    return plan


def feature_channels(name: str) -> int:
    """Channels of the stride-32 map."""
    return stage_plan(name)[-1][0]


class ConvBn(nn.Module):
    """timm ``ConvBnAct`` without its act: ``conv`` then ``bn``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, groups: int = 1,
                 observers: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = QConv(cin, cout, k, stride, groups=groups, observer=observers, dtype=dtype)
        self.bn = FrozenBatchNorm2d(cout, dtype)

    def forward(self, x: torch.Tensor, mode: str = "none", observe: bool = False) -> torch.Tensor:
        return self.bn(self.conv(x, mode, observe))


class RegNetBottleneck(nn.Module):
    """timm RegNet ``Bottleneck`` of ratio 1."""

    def __init__(self, cin: int, width: int, stride: int, group_width: int, se_reduced: int,
                 observers: bool, dtype: torch.dtype):
        super().__init__()
        kw = dict(observers=observers, dtype=dtype)
        self.conv1 = ConvBn(cin, width, 1, **kw)
        self.conv2 = ConvBn(width, width, 3, stride, groups=width // group_width, **kw)
        self.se = SqueezeExcite(width, se_reduced, F.relu, ("fc1", "fc2")) if se_reduced else None
        self.conv3 = ConvBn(width, width, 1, **kw)
        self.downsample = (ConvBn(cin, width, 1, stride, **kw)
                           if stride != 1 or cin != width else None)

    def forward(self, x: torch.Tensor, mode: str, observe: bool) -> torch.Tensor:
        h = F.relu(self.conv1(x, mode, observe))
        h = F.relu(self.conv2(h, mode, observe))
        if self.se is not None:
            h = self.se(h)
        h = self.conv3(h, mode, observe)
        shortcut = x if self.downsample is None else self.downsample(x, mode, observe)
        return F.relu(h + shortcut)


class RegNet(TimmTrunk):
    """The features-only trunk, stride 32 (``models/timm.py``)."""

    family = "RegNet"

    def __init__(self, arch: str = "regnety_008", quant: str = "none",
                 dtype: torch.dtype = torch.float32, observers: Optional[str] = None,
                 stages: int = 4):
        super().__init__(quant, dtype, observers, stages)
        observed = self.observers == "all"
        self.out_channels = feature_channels(arch)
        self.stem = ConvBn(3, STEM_CH, 3, 2, dtype=dtype)
        c_prev = STEM_CH
        for si, (width, depth, gw, se) in enumerate(stage_plan(arch), start=1):
            stage = nn.ModuleDict()
            for bi in range(1, depth + 1):
                se_reduced = int(round(c_prev * se)) if se else 0  # of the block's input
                stage[f"b{bi}"] = RegNetBottleneck(c_prev, width, 2 if bi == 1 else 1, gw,
                                                   se_reduced, observed, dtype)
                c_prev = width
            setattr(self, f"s{si}", stage)

    def features(self, x: torch.Tensor, mode: str, observe: bool) -> torch.Tensor:
        x = F.relu(self.stem(x.permute(0, 3, 1, 2)))
        for si in range(1, min(self.n_stages, 4) + 1):
            for block in getattr(self, f"s{si}").values():
                x = block(x, mode, observe)
        return x.permute(0, 2, 3, 1)
