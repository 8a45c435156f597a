"""ConvNeXt tiny/small/base trunks with timm's names (counterpart of ``tubedetr_tpu/models/convnext.py``).

timm's ConvNeXt (timm >= 0.5 layout): a patchify stem (``stem.0``, 4x4/s4
conv with bias, padding 0; ``stem.1``, LayerNorm over channels), then stages
``stages.{i}``: for i >= 1 a ``downsample`` (``downsample.0`` LayerNorm,
``downsample.1`` 2x2/s2 conv with bias, padding 0), and blocks
``blocks.{j}``: ``conv_dw`` 7x7 depthwise with bias -> ``norm`` LayerNorm
(eps 1e-6, channels last) -> ``mlp.fc1`` (4x) -> exact-erf GELU ->
``mlp.fc2`` -> layer scale ``gamma`` -> residual add. There is no
BatchNorm: every LayerNorm is a parameter and trains under
``lr_backbone``.

The quantized modes run ``mlp.fc1`` and ``mlp.fc2`` alone int8, timm
``Linear``s here and 1x1 convs in the JAX package (``models/timm.py``); the
7x7 depthwise conv, the stem and the downsamples stay float. The
LayerNorms return the compute dtype, the float convs compute in float32.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from tubedetr_tpu_torch.models.layers import LayerNorm, gelu
from tubedetr_tpu_torch.models.resnet import Float32Conv, QLinear
from tubedetr_tpu_torch.models.timm import TimmTrunk

# name -> (depths, dims): the paper's tiny, small and base
CONVNEXT_CFGS = {
    "convnext_tiny": ((3, 3, 9, 3), (96, 192, 384, 768)),
    "convnext_small": ((3, 3, 27, 3), (96, 192, 384, 768)),
    "convnext_base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
}

LN_EPS = 1e-6


def arch_config(name: str) -> Tuple[List[int], List[int]]:
    depths, dims = CONVNEXT_CFGS[name]
    return list(depths), list(dims)


def feature_channels(name: str) -> int:
    """Channels of the stride-32 map."""
    return CONVNEXT_CFGS[name][1][-1]


def _nchw(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``conv`` of an NHWC tensor, NHWC out."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class Mlp(nn.Module):
    """timm ``Mlp``: ``fc1`` and ``fc2``, the GELU between."""

    def __init__(self, dim: int, observers: bool, dtype: torch.dtype):
        super().__init__()
        self.fc1 = QLinear(dim, 4 * dim, observer=observers, dtype=dtype)
        self.fc2 = QLinear(4 * dim, dim, observer=observers, dtype=dtype)

    def forward(self, x: torch.Tensor, mode: str, observe: bool) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x, mode, observe)), mode, observe)


class ConvNeXtBlock(nn.Module):
    """timm ``ConvNeXtBlock``, NHWC."""

    def __init__(self, dim: int, observers: bool, dtype: torch.dtype):
        super().__init__()
        self.conv_dw = Float32Conv(dim, dim, 7, padding=3, groups=dim, bias=True)
        self.norm = LayerNorm(dim, LN_EPS, dtype)
        self.mlp = Mlp(dim, observers, dtype)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))  # timm ls_init_value

    def forward(self, x: torch.Tensor, mode: str, observe: bool) -> torch.Tensor:
        h = self.mlp(self.norm(_nchw(self.conv_dw, x)), mode, observe)
        return x + self.gamma.to(h.dtype) * h


class ConvNeXtStage(nn.Module):
    def __init__(self, cin: int, dim: int, depth: int, downsample: bool, observers: bool,
                 dtype: torch.dtype):
        super().__init__()
        if downsample:
            self.downsample = nn.ModuleList([LayerNorm(cin, LN_EPS, dtype),
                                             Float32Conv(cin, dim, 2, stride=2, bias=True)])
        self.blocks = nn.ModuleList([ConvNeXtBlock(dim, observers, dtype) for _ in range(depth)])

    def forward(self, x: torch.Tensor, mode: str, observe: bool) -> torch.Tensor:
        if hasattr(self, "downsample"):
            norm, conv = self.downsample
            x = _nchw(conv, norm(x))
        for block in self.blocks:
            x = block(x, mode, observe)
        return x


class ConvNeXt(TimmTrunk):
    """The features-only trunk, stride 32 (``models/timm.py``)."""

    family = "ConvNeXt"

    def __init__(self, arch: str = "convnext_tiny", quant: str = "none",
                 dtype: torch.dtype = torch.float32, observers: Optional[str] = None,
                 stages: int = 4):
        super().__init__(quant, dtype, observers, stages)
        depths, dims = arch_config(arch)
        observed = self.observers == "all"
        self.out_channels = dims[-1]
        self.stem = nn.ModuleList([Float32Conv(3, dims[0], 4, stride=4, bias=True),
                                   LayerNorm(dims[0], LN_EPS, dtype)])
        self.stages = nn.ModuleList([
            ConvNeXtStage(dims[si - 1] if si else dims[0], dim, depth, si > 0, observed, dtype)
            for si, (depth, dim) in enumerate(zip(depths, dims))
        ])

    def features(self, x: torch.Tensor, mode: str, observe: bool) -> torch.Tensor:
        x = self.stem[1](_nchw(self.stem[0], x))
        for stage in self.stages[: self.n_stages]:
            x = stage(x, mode, observe)
        return x
