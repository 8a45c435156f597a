"""EfficientNet b0-b3 trunks with timm's names (counterpart of ``tubedetr_tpu/models/efficientnet.py``).

The public EfficientNet definition, timm's non-tf variants (symmetric
``k // 2`` padding): a 3x3/s2 stem (``conv_stem`` -> ``bn1`` -> SiLU), stage
0 of ``DepthwiseSeparable`` blocks (``conv_dw`` -> ``bn1`` -> SiLU -> ``se``
-> ``conv_pw`` -> ``bn2``), stages 1-6 of ``InvertedResidual`` blocks
(``conv_pw`` -> ``bn1`` -> SiLU -> ``conv_dw`` -> ``bn2`` -> SiLU -> ``se``
-> ``conv_pwl`` -> ``bn3``), a residual where the stride is 1 and the
channels match; the squeeze-excite reduces to a quarter of the block's
input channels. Names: ``conv_stem``, ``bn1``, ``blocks.{s}.{b}.{conv_dw,
bn1,se.conv_reduce,se.conv_expand,conv_pw,bn2,conv_pwl,bn3}``. The trunk
returns the stride-32 map (320 channels for b0).

The quantized modes run ``conv_pw``, ``conv_dw`` (G1, a depthwise conv) and
``conv_pwl`` int8 (``models/timm.py``); the stem and the SE projections stay
float.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from tubedetr_tpu_torch.models.layers import sigmoid
from tubedetr_tpu_torch.models.resnet import Float32Conv, FrozenBatchNorm2d, QConv
from tubedetr_tpu_torch.models.timm import SqueezeExcite, TimmTrunk

# (expand_ratio, channels, repeats, stride, kernel): the B0 baseline
B0_STAGES: List[Tuple[int, int, int, int, int]] = [
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
]

# (width_mult, depth_mult) per variant
VARIANTS = {
    "efficientnet_b0": (1.0, 1.0),
    "efficientnet_b1": (1.0, 1.1),
    "efficientnet_b2": (1.1, 1.2),
    "efficientnet_b3": (1.2, 1.4),
}


def round_channels(c: float, mult: float, divisor: int = 8) -> int:
    """timm ``round_channels``: scale, then round to the nearest multiple of
    8, never below 90% of the scaled width."""
    c *= mult
    new_c = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new_c < 0.9 * c:
        new_c += divisor
    return new_c


def round_repeats(r: int, mult: float) -> int:
    return int(math.ceil(mult * r))


def arch_config(name: str):
    """(stem width, per-stage (expand, channels, repeats, stride, kernel))
    after scaling."""
    wm, dm = VARIANTS[name]
    stages = [(e, round_channels(c, wm), round_repeats(r, dm), s, k)
              for (e, c, r, s, k) in B0_STAGES]
    return round_channels(32, wm), stages


def feature_channels(name: str) -> int:
    """Channels of the stride-32 map."""
    return arch_config(name)[1][-1][1]


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)``: ``F.silu`` in float32, below it each step in
    ``x``'s dtype (``layers.sigmoid``)."""
    return F.silu(x) if x.dtype == torch.float32 else x * sigmoid(x)


class DepthwiseSeparable(nn.Module):
    """timm ``DepthwiseSeparableConv`` (stage 0, expand ratio 1)."""

    def __init__(self, cin: int, cout: int, stride: int, k: int, se_reduced: int,
                 observers: bool, dtype: torch.dtype):
        super().__init__()
        self.conv_dw = QConv(cin, cin, k, stride, groups=cin, observer=observers, dtype=dtype)
        self.bn1 = FrozenBatchNorm2d(cin, dtype)
        self.se = SqueezeExcite(cin, se_reduced, silu)
        self.conv_pw = QConv(cin, cout, 1, observer=observers, dtype=dtype)
        self.bn2 = FrozenBatchNorm2d(cout, dtype)
        self.residual = stride == 1 and cin == cout

    def forward(self, x: torch.Tensor, mode: str, observe: bool) -> torch.Tensor:
        h = silu(self.bn1(self.conv_dw(x, mode, observe)))
        h = self.bn2(self.conv_pw(self.se(h), mode, observe))
        return h + x if self.residual else h


class InvertedResidual(nn.Module):
    """timm ``InvertedResidual`` (MBConv)."""

    def __init__(self, cin: int, cout: int, stride: int, k: int, expand: int, se_reduced: int,
                 observers: bool, dtype: torch.dtype):
        super().__init__()
        mid = cin * expand
        self.conv_pw = QConv(cin, mid, 1, observer=observers, dtype=dtype)
        self.bn1 = FrozenBatchNorm2d(mid, dtype)
        self.conv_dw = QConv(mid, mid, k, stride, groups=mid, observer=observers, dtype=dtype)
        self.bn2 = FrozenBatchNorm2d(mid, dtype)
        self.se = SqueezeExcite(mid, se_reduced, silu)
        self.conv_pwl = QConv(mid, cout, 1, observer=observers, dtype=dtype)
        self.bn3 = FrozenBatchNorm2d(cout, dtype)
        self.residual = stride == 1 and cin == cout

    def forward(self, x: torch.Tensor, mode: str, observe: bool) -> torch.Tensor:
        h = silu(self.bn1(self.conv_pw(x, mode, observe)))
        h = silu(self.bn2(self.conv_dw(h, mode, observe)))
        h = self.bn3(self.conv_pwl(self.se(h), mode, observe))
        return h + x if self.residual else h


class EfficientNet(TimmTrunk):
    """The features-only trunk, stride 32 (``models/timm.py``)."""

    family = "EfficientNet"

    def __init__(self, arch: str = "efficientnet_b0", quant: str = "none",
                 dtype: torch.dtype = torch.float32, observers: Optional[str] = None,
                 stages: int = 7):
        super().__init__(quant, dtype, observers, stages)
        stem_ch, plan = arch_config(arch)
        observed = self.observers == "all"
        self.out_channels = feature_channels(arch)
        self.conv_stem = Float32Conv(3, stem_ch, 3, stride=2, padding=1, bias=False)
        self.bn1 = FrozenBatchNorm2d(stem_ch, dtype)
        c_prev, blocks = stem_ch, []
        for expand, ch, repeats, stride, kernel in plan:
            stage = []
            for bi in range(repeats):
                s = stride if bi == 0 else 1
                se_reduced = max(1, int(c_prev * 0.25))  # of the block's input channels
                if expand == 1:
                    stage.append(DepthwiseSeparable(c_prev, ch, s, kernel, se_reduced, observed,
                                                    dtype))
                else:
                    stage.append(InvertedResidual(c_prev, ch, s, kernel, expand, se_reduced,
                                                  observed, dtype))
                c_prev = ch
            blocks.append(nn.ModuleList(stage))
        self.blocks = nn.ModuleList(blocks)

    def features(self, x: torch.Tensor, mode: str, observe: bool) -> torch.Tensor:
        x = silu(self.bn1(self.conv_stem(x.permute(0, 3, 1, 2))))
        for stage in self.blocks[: self.n_stages]:
            for block in stage:
                x = block(x, mode, observe)
        return x.permute(0, 2, 3, 1)
