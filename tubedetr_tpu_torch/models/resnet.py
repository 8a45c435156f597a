"""ResNet trunk with frozen batch norm or GroupNorm (counterpart of ``tubedetr_tpu/models/resnet.py``).

Module names follow torchvision, so the reference ``backbone.0.body.*``
weights load as they are. The public input/output is NHWC as in the JAX
package. ``resnet*-gn`` puts ``GroupNorm(32, eps=1e-5)`` where the others
have FrozenBN: its weight and bias are parameters, frozen with the stem and
layer1 and trained with layer2-4, as every conv is.

``quant="none"``: the float trunk, computing in ``dtype`` with float32
parameters: each conv casts its input and weight at use, FrozenBN folds in
float32 and applies in ``dtype``, GroupNorm normalizes in float32 and
returns ``dtype``. Inside, the NHWC tensor is viewed as NCHW in
``channels_last`` memory format, the layout cuDNN runs fastest;
convolutions are stock PyTorch, as the JAX package left them to XLA.

``quant="int8"`` (dynamic scales; with ``observe`` the activation maxima are
recorded: PTQ calibration) and ``"int8_static"`` (calibrated scales): the
bottleneck convs run s8 x s8 -> s32 on per-out-channel int8 weights
(``ops/int8_conv.py``), and the residual stream between blocks is carried as
``(int8 NHWC tensor, f32 scale)``. The stem stays float; it is quantized with
``stem_act_max`` after the max pool. With ``fused_blocks`` the int8_static
stride-1 tail blocks run as one K2 launch each (``ops/fused_bottleneck.py``).
For training, the stem and layer1 are always frozen (``requires_grad``
off, as the reference's backbone freezes them); with ``remat`` each block
that holds a trainable weight runs under ``torch.utils.checkpoint`` while
gradients are on, so its activations are recomputed in the backward.
``remat_policy`` says what such a block keeps for the backward besides its
input: ``"full"`` (or ``""``) nothing; ``"save_mid"`` the 3x3 conv's output
(conv3's input ``a2`` is its norm and ReLU), so the backward recomputes
conv1 and conv3 but not the 3x3; ``"save_acts"`` conv1's output too
(``a1`` is its norm and ReLU), so only conv3 and the downsample are
recomputed. The policies are selective-checkpoint contexts over the
block's convolutions; they change what is stored, never a value.

The calibrated maxima are non-persistent buffers (``stem_act_max``,
``layerI.J.conv2.act_max``, ``layerI.J.conv3.act_max``, ``layerI.J.out_max``),
so the ``state_dict`` keeps the reference grammar; ``interop/from_jax.py``
maps them to and from the JAX package's ``qscales`` tree.
"""

from __future__ import annotations

from contextlib import contextmanager
from functools import partial
from typing import Dict

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from tubedetr_tpu_torch.ops.fused_bottleneck import (
    fold_bottleneck,
    fused_bottleneck_block,
    quantize_weight,
)
from tubedetr_tpu_torch.ops.int8_conv import conv2d_int8

BN_EPS = 1e-5
QUANT_MODES = ("none", "int8", "int8_static")
OBSERVERS = ("act_max", "out_max", "stem_act_max")

STAGE_BLOCKS = {
    "resnet14": (1, 1, 1, 1),  # tiny test arch (not in torchvision)
    "resnet26": (2, 2, 2, 2),
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet152": (3, 8, 36, 3),
}
# remat_policy -> which of a block's convolutions (in call order: conv1,
# conv2, conv3, downsample) keep their outputs for the backward
KEPT_CONVS = {"": (), "full": (), "save_mid": (1,), "save_acts": (0, 1)}


def parse_backbone_name(name: str):
    """'resnet101' -> ('resnet101', 'frozen_bn'); 'resnet101-gn' -> (..., 'gn')."""
    if name.endswith("-gn"):
        return name[:-3], "gn"
    return name, "frozen_bn"


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``dtype``: input and weight cast at use."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt),
                                  None if self.bias is None else self.bias.to(dt))


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

    def fold(self):
        """(scale, shift), float32."""
        scale = self.weight.float() * torch.rsqrt(self.running_var.float() + BN_EPS)
        return scale, self.bias.float() - self.running_mean.float() * scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        scale, shift = self.fold()
        return x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]

    def channels_last(self, x: torch.Tensor) -> torch.Tensor:  # (..., C)
        scale, shift = self.fold()
        return x * scale.to(x.dtype) + shift.to(x.dtype)


class GroupNorm(nn.GroupNorm):
    """``GroupNorm(32, eps=1e-5)`` of the ``-gn`` trunks: statistics and
    affine in float32 on the float32 input, the result in ``dtype`` (flax
    ``GroupNorm`` with ``dtype``)."""

    def __init__(self, n: int, dtype: torch.dtype = torch.float32):
        super().__init__(32, n, eps=BN_EPS)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        return F.group_norm(x.float(), self.num_groups, self.weight.float(), self.bias.float(),
                            self.eps).to(self.compute_dtype)


def make_norm(norm: str, n: int, dtype: torch.dtype) -> nn.Module:
    return GroupNorm(n, dtype) if norm == "gn" else FrozenBatchNorm2d(n)


def _keep_convs(kept) -> tuple:
    """A selective-checkpoint context pair that keeps the outputs of the
    convolutions numbered ``kept`` (in call order) and recomputes the rest.
    The forward and the recompute count their convolutions apart."""
    seen = {False: 0, True: 0}

    def policy(ctx, op, *args, **kwargs):
        if op is torch.ops.aten.convolution.default:
            i = seen[ctx.is_recompute]
            seen[ctx.is_recompute] = i + 1
            if i in kept:
                return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return create_selective_checkpoint_contexts(policy)


def _observer(module: nn.Module, name: str = "act_max") -> None:
    module.register_buffer(name, torch.zeros(()), persistent=False)


def quantize_act(x: torch.Tensor, act_max: torch.Tensor, mode: str, observe: bool):
    """Per-tensor symmetric int8 of a float activation -> (int8, f32 scale).

    ``int8_static`` reads the calibrated ``act_max``; ``int8`` uses the
    tensor's own max |x| and, with ``observe``, raises ``act_max`` to it."""
    xf = x.float()
    if mode == "int8_static":
        s = torch.clamp_min(act_max, 1e-6) / 127.0
    else:
        ax = xf.abs().amax()
        if observe:
            act_max.copy_(torch.maximum(act_max, ax))
        s = torch.clamp_min(ax, 1e-8) / 127.0
    return torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8), s


def _weights_key(*tensors):
    """What a cache derived from ``tensors`` is valid for: each tensor
    object, its storage and its version. Swapped-in weights (the EMA's,
    through ``functional_call`` or a ``.data`` swap) or weights changed in
    place (an optimizer step, ``load_state_dict``) give another key."""
    return tuple((t, t.data_ptr(), -1 if t.is_inference() else t._version) for t in tensors)


def _same_key(a, b) -> bool:
    return a is not None and len(a) == len(b) and all(
        x[0] is y[0] and x[1:] == y[1:] for x, y in zip(a, b))


def _int8_weight(conv: nn.Conv2d):
    """(wq (O, kh*kw*I) int8, sw (O,) f32) of ``conv``, quantized from the
    float weight it holds now and cached on the module for that weight."""
    key = _weights_key(conv.weight)
    cached = getattr(conv, "_int8", None)
    if cached is None or not _same_key(cached[0], key):
        hwio = conv.weight.detach().float().permute(2, 3, 1, 0)
        wq, sw = quantize_weight(hwio)
        cached = (key, wq.permute(3, 0, 1, 2).reshape(wq.shape[3], -1).contiguous(), sw)
        conv._int8 = cached
    return cached[1:]


def qconv(conv: nn.Conv2d, xq: torch.Tensor, sx: torch.Tensor, dtype) -> torch.Tensor:
    """An int8 conv on ``(xq, sx)`` NHWC: ``(acc.f32 * (sx * sw)).to(dtype)``."""
    wq, sw = _int8_weight(conv)
    acc = conv2d_int8(xq, wq, conv.kernel_size[0], conv.stride[0], conv.dilation[0])
    return (acc.float() * (sx * sw)).to(dtype)


class Bottleneck(nn.Module):
    """torchvision v1.5 bottleneck: stride on the 3x3 conv."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False, quant: str = "none",
                 fused: bool = False, norm: str = "frozen_bn",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False, dtype=dtype)
        self.bn1 = make_norm(norm, planes, dtype)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=dilation,
                            dilation=dilation, bias=False, dtype=dtype)
        self.bn2 = make_norm(norm, planes, dtype)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False, dtype=dtype)
        self.bn3 = make_norm(norm, planes * 4, dtype)
        self.downsample = (
            nn.Sequential(
                Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False, dtype=dtype),
                make_norm(norm, planes * 4, dtype),
            )
            if downsample
            else None
        )
        self.stride, self.dilation, self.fused = stride, dilation, fused
        self._fold = None
        if quant != "none":  # conv1 and the downsample read the int8 stream as it is
            _observer(self.conv2)
            _observer(self.conv3)
            _observer(self, "out_max")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)

    def forward_int8(self, xq: torch.Tensor, sx: torch.Tensor, dtype, mode: str,
                     observe: bool = False):
        """On the int8 stream: ``(xq (N, H, W, C) int8, sx)`` -> ``(oq, so)``,
        float work in ``dtype``. Stride-1 tails of an int8_static trunk with
        ``fused`` go through K2 (the conditions of the JAX ``Bottleneck``)."""
        if self.fused and mode == "int8_static" and self.downsample is None and self.stride == 1:
            # static scales: the fold is a constant of the weights and norms it was made from
            key = _weights_key(*(t for i in (1, 2, 3) for t in (
                getattr(self, f"conv{i}").weight, *getattr(self, f"bn{i}").buffers())))
            if self._fold is None or not _same_key(self._fold[0], key):
                self._fold = (key, fold_bottleneck(
                    sx,
                    {f"conv{i}": getattr(self, f"conv{i}").weight.detach().float().permute(2, 3, 1, 0)
                     for i in (1, 2, 3)},
                    {f"bn{i}": getattr(self, f"bn{i}").fold() for i in (1, 2, 3)},
                    self.conv2.act_max, self.conv3.act_max, self.out_max,
                ))
            return fused_bottleneck_block(xq, self._fold[1], self.dilation)
        out = F.relu(self.bn1.channels_last(qconv(self.conv1, xq, sx, dtype)))
        q, s = quantize_act(out, self.conv2.act_max, mode, observe)
        out = F.relu(self.bn2.channels_last(qconv(self.conv2, q, s, dtype)))
        q, s = quantize_act(out, self.conv3.act_max, mode, observe)
        out = self.bn3.channels_last(qconv(self.conv3, q, s, dtype))
        if self.downsample is not None:
            conv, bn = self.downsample
            identity = bn.channels_last(qconv(conv, xq, sx, dtype))
        else:
            identity = (xq.float() * sx).to(dtype)
        return quantize_act(F.relu(out + identity), self.out_max, mode, observe)


class ResNet(nn.Module):
    """Trunk returning the layer4 map: stride 32, 2048 channels (stride 16
    with ``dilation``, the DC5 variant: layer4 keeps stride 1 and dilates its
    3x3 convs by 2, its first block keeping the previous dilation of 1)."""

    def __init__(self, arch: str = "resnet101", dilation: bool = False,
                 quant: str = "none", fused_blocks: bool = False, remat: bool = False,
                 remat_policy: str = "full", dtype: torch.dtype = torch.float32):
        super().__init__()
        base, norm = parse_backbone_name(arch)
        if base not in STAGE_BLOCKS:
            raise NotImplementedError(f"backbone {arch!r}; expected one of {sorted(STAGE_BLOCKS)}"
                                      " (each also with -gn)")
        if quant not in QUANT_MODES:
            raise NotImplementedError(f"quant {quant!r}; expected one of {QUANT_MODES}")
        if quant != "none" and norm == "gn":
            raise NotImplementedError("the int8 trunk runs on FrozenBN; a GroupNorm trunk is float")
        if remat_policy not in KEPT_CONVS:
            raise NotImplementedError(f"remat_policy {remat_policy!r}; expected one of "
                                      f"{sorted(KEPT_CONVS)}")
        self.quant = quant
        self.remat = remat
        self.kept_convs = KEPT_CONVS[remat_policy]
        self.observe = False  # int8: record activation maxima (calibration)
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False, dtype=dtype)
        self.bn1 = make_norm(norm, 64, dtype)
        if quant != "none":
            _observer(self, "stem_act_max")
        inplanes, cur_dilation = 64, 1
        for i, (planes, n_blocks) in enumerate(zip((64, 128, 256, 512), STAGE_BLOCKS[base])):
            stride = 1 if i == 0 else 2
            prev_dilation = cur_dilation
            if i == 3 and dilation:
                cur_dilation *= stride
                stride = 1
            blocks = [Bottleneck(inplanes, planes, stride, prev_dilation, downsample=True,
                                 quant=quant, norm=norm, dtype=dtype)]
            inplanes = planes * 4
            blocks += [
                Bottleneck(inplanes, planes, 1, cur_dilation, quant=quant, fused=fused_blocks,
                           norm=norm, dtype=dtype)
                for _ in range(1, n_blocks)
            ]
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        for frozen in (self.conv1, self.bn1, self.layer1):
            frozen.requires_grad_(False)
        self.register_load_state_dict_post_hook(lambda module, _: module.clear_int8_cache())

    def blocks(self):
        for i in (1, 2, 3, 4):
            yield from getattr(self, f"layer{i}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) NHWC -> (N, h, w, 2048) NHWC."""
        x = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory = channels_last
        x = F.relu(self.bn1(self.conv1(x)))
        # max pool in float, then quantize: exact, as the JAX package's
        # quantize-then-pool, since round and clip are monotone and every
        # pixel lies in some 3x3/s2 pad-1 window (same max either side)
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        if self.quant == "none":
            for block in self.blocks():
                if self.remat and torch.is_grad_enabled() and block.conv1.weight.requires_grad:
                    context = (partial(_keep_convs, self.kept_convs) if self.kept_convs
                               else None)
                    x = checkpoint(block, x, use_reentrant=False,
                                   **({"context_fn": context} if context else {}))
                else:
                    x = block(x)
            return x.permute(0, 2, 3, 1)
        dtype = x.dtype
        x = x.permute(0, 2, 3, 1).contiguous()
        xq, sx = quantize_act(x, self.stem_act_max, self.quant, self.observe)
        for block in self.blocks():
            xq, sx = block.forward_int8(xq, sx, dtype, self.quant, self.observe)
        return (xq.float() * sx).to(dtype)

    # -- int8 state -------------------------------------------------------
    def int8_convs(self):
        """The convs that run on int8 weights (every bottleneck conv), or
        none for the float trunk: these keep float32 weights."""
        if self.quant == "none":
            return []
        return [m for b in self.blocks() for m in b.modules() if isinstance(m, nn.Conv2d)]

    def clear_int8_cache(self) -> None:
        """Drop the cached int8 weights and K2 folds (new weights or scales)."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m._int8 = None
            elif isinstance(m, Bottleneck):
                m._fold = None

    def qscales(self, prefix: str = "") -> Dict[str, torch.Tensor]:
        """The calibrated maxima by buffer name."""
        return {f"{prefix}{k}": v for k, v in self.named_buffers()
                if k.rsplit(".", 1)[-1] in OBSERVERS}

    def load_qscales(self, qscales: Dict, prefix: str = "") -> None:
        """Set every calibrated maximum from ``qscales`` (names as
        ``qscales()`` gives them); the key sets must match."""
        own = self.qscales(prefix)
        if set(own) != set(qscales):
            raise KeyError(
                f"qscales do not match the trunk: missing {sorted(set(own) - set(qscales))[:5]}, "
                f"unexpected {sorted(set(qscales) - set(own))[:5]}"
            )
        with torch.no_grad():
            for k, buf in own.items():
                v = qscales[k]
                buf.fill_(v.item() if torch.is_tensor(v) else float(np.asarray(v).reshape(())))
        self.clear_int8_cache()

    @contextmanager
    def calibrating(self, mode: str = "int8"):
        """Run the dynamic-observer trunk (``mode``) inside: the maxima start
        at 0 and each forward raises them to what it sees."""
        if self.quant == "none":
            raise ValueError("the float trunk has no quantization observers")
        saved = self.quant
        with torch.no_grad():
            for buf in self.qscales().values():
                buf.zero_()
        self.quant, self.observe = mode, True
        try:
            yield self
        finally:
            self.quant, self.observe = saved, False
            self.clear_int8_cache()

    @staticmethod
    def feature_hw(h: int, w: int, dilation: bool = False):
        """Output spatial dims for an (h, w) input: five ceil-halvings (four with DC5)."""
        for _ in range(4 if dilation else 5):
            h, w = -(-h // 2), -(-w // 2)
        return h, w
