"""ResNet trunk with frozen batch norm (counterpart of ``tubedetr_tpu/models/resnet.py``).

Float path only (``quant="none"``). Module names follow torchvision, so the
reference ``backbone.0.body.*`` weights load as they are. The public
input/output is NHWC as in the JAX package; inside, the NHWC tensor is viewed
as NCHW in ``channels_last`` memory format, the layout cuDNN runs fastest.
Convolutions are stock PyTorch, as the JAX package left them to XLA.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

BN_EPS = 1e-5

STAGE_BLOCKS = {
    "resnet14": (1, 1, 1, 1),  # tiny test arch (not in torchvision)
    "resnet26": (2, 2, 2, 2),
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet152": (3, 8, 36, 3),
}


class FrozenBatchNorm2d(nn.Module):
    """Fixed-statistics batch norm, ``y = x * scale + shift`` with
    ``scale = weight * rsqrt(running_var + eps)`` (eps inside the rsqrt).

    The four raw buffers keep the reference's names. The fold runs in float32
    and is cast to the activation dtype, as the JAX package does; the model's
    ``cast_compute`` leaves these buffers in float32."""

    def __init__(self, n: int):
        super().__init__()
        self.register_buffer("weight", torch.ones(n))
        self.register_buffer("bias", torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        scale = self.weight.float() * torch.rsqrt(self.running_var.float() + BN_EPS)
        shift = self.bias.float() - self.running_mean.float() * scale
        return x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


class Bottleneck(nn.Module):
    """torchvision v1.5 bottleneck: stride on the 3x3 conv."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=dilation,
                               dilation=dilation, bias=False)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(planes * 4)
        self.downsample = (
            nn.Sequential(
                nn.Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False),
                FrozenBatchNorm2d(planes * 4),
            )
            if downsample
            else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet(nn.Module):
    """Trunk returning the layer4 map: stride 32, 2048 channels (stride 16
    with ``dilation``, the DC5 variant: layer4 keeps stride 1 and dilates its
    3x3 convs by 2, its first block keeping the previous dilation of 1)."""

    def __init__(self, arch: str = "resnet101", dilation: bool = False):
        super().__init__()
        if arch not in STAGE_BLOCKS:
            raise NotImplementedError(f"backbone {arch!r}; expected one of {sorted(STAGE_BLOCKS)}")
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        inplanes, cur_dilation = 64, 1
        for i, (planes, n_blocks) in enumerate(zip((64, 128, 256, 512), STAGE_BLOCKS[arch])):
            stride = 1 if i == 0 else 2
            prev_dilation = cur_dilation
            if i == 3 and dilation:
                cur_dilation *= stride
                stride = 1
            blocks = [Bottleneck(inplanes, planes, stride, prev_dilation, downsample=True)]
            inplanes = planes * 4
            blocks += [
                Bottleneck(inplanes, planes, 1, cur_dilation) for _ in range(1, n_blocks)
            ]
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) NHWC -> (N, h, w, 2048) NHWC."""
        x = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory = channels_last
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return x.permute(0, 2, 3, 1)

    @staticmethod
    def feature_hw(h: int, w: int, dilation: bool = False):
        """Output spatial dims for an (h, w) input: five ceil-halvings (four with DC5)."""
        for _ in range(4 if dilation else 5):
            h, w = -(-h // 2), -(-w // 2)
        return h, w
