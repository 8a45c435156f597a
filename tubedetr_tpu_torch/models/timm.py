"""What the three timm trunk families share (counterparts of
``tubedetr_tpu/models/efficientnet.py``, ``regnet.py`` and ``convnext.py``).

The reference's ``TimmBackbone`` wraps a timm ``features_only`` model and
feeds its stride-32 map to ``input_proj``; the families here rebuild those
trunks with timm's module names (``models/efficientnet.py``,
``models/regnet.py``, ``models/convnext.py``), so a reference
``backbone.0.body.*`` checkpoint of one loads as it is. Each trunk is a
``TimmTrunk``: the interface the rest of the port calls on
``backbone[0].body`` (``forward(x, quant=..., frozen_prefix_quant=...)``,
NHWC in and out; the int8 state of ``QuantTrunk``; ``observers``), with

* ``quant`` in ``none``, ``int8``, ``int8_static`` and ``int8_qat`` on the
  trunk's ``QConv``/``QLinear`` modules, each quantizing its own input with
  its own ``act_max`` (there is no int8 residual stream here); the stems and
  the squeeze-excite projections stay float;
* the float convs computing in float32 whatever the compute dtype (flax's
  ``nn.Conv`` without ``dtype`` promotes a bfloat16 input to its float32
  kernel), the FrozenBN folds rounded to the compute dtype, the int8 and
  QAT convs returning the compute dtype, so that ``TubeDETR.cast_compute``
  keeps every trunk parameter in float32 (``float32_modules``);
* no always-frozen prefix: every trunk parameter trains under
  ``lr_backbone`` (the reference freezes only BatchNorm, which is buffers
  here), so ``frozen_prefix_quant`` raises;
* ``stages=N``, the JAX package's profiling aid: the first N stages only,
  0 the stem's output.

``timm_trunk_class`` resolves a ``timm_*`` backbone name, with the JAX
package's message for a name none of the three tables holds.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tubedetr_tpu_torch.models.resnet import QUANT_MODES, Float32Conv, QConv, QLinear, QuantTrunk


class TimmTrunk(QuantTrunk, nn.Module):
    """A timm family's trunk: ``features(x, mode, observe)`` on NHWC frames
    in the compute dtype, the rest here."""

    family = ""

    def __init__(self, quant: str, dtype: torch.dtype, observers: Optional[str], stages: int):
        super().__init__()
        if quant not in QUANT_MODES:
            raise NotImplementedError(f"quant {quant!r}; expected one of {QUANT_MODES}")
        if observers is None:
            observers = "all" if quant != "none" else ""
        if observers not in ("", "all") or (quant != "none" and observers != "all"):
            raise ValueError(f"observers {observers!r} for quant {quant!r}: a {self.family} "
                             "trunk holds every observer or none ('all' when quantized)")
        self.quant, self.observers, self.observe = quant, observers, False
        self.dtype, self.n_stages = dtype, stages

    def forward(self, x: torch.Tensor, quant: Optional[str] = None,
                frozen_prefix_quant: Optional[str] = None) -> torch.Tensor:
        """(N, H, W, 3) NHWC -> (N, h, w, C) NHWC, in the trunk's mode or in
        ``quant`` on the same weights (the training fast pass)."""
        if frozen_prefix_quant not in (None, "none"):
            raise NotImplementedError(f"{self.family} has no always-frozen prefix; "
                                      "backbone_quant_frozen applies to the resnet family only")
        mode = self.quant if quant is None else quant
        if mode not in QUANT_MODES:
            raise NotImplementedError(f"quant {mode!r}; expected one of {QUANT_MODES}")
        if mode != "none" and not self.observers:
            raise ValueError(f"a {mode} pass needs the trunk's observers (a float trunk has none)")
        return self.features(x.to(self.dtype), mode, self.observe)

    def int8_convs(self):
        """The convs that run int8 or fake-quantized in a quantized pass
        (none for a float trunk)."""
        return [m for m in self.modules()
                if isinstance(m, (QConv, QLinear)) and hasattr(m, "act_max")]

    def float32_modules(self):
        """Every module: the float convs compute in float32, the quantized
        ones quantize from float32, and the folds and the layer scale are
        rounded at use."""
        return list(self.modules())


class SqueezeExcite(nn.Module):
    """Mean-pool -> ``reduce`` (1x1, bias) -> ``act`` -> ``expand`` ->
    sigmoid gate, on an NCHW view; both projections float32 (timm's
    ``SqueezeExcite``, ``conv_reduce``/``conv_expand``, and RegNet's
    ``SEModule``, ``fc1``/``fc2``). The gate multiplies in the promotion of
    the input's dtype and float32."""

    def __init__(self, c: int, reduced: int, act, names=("conv_reduce", "conv_expand")):
        super().__init__()
        self.act, self.names = act, names
        setattr(self, names[0], Float32Conv(c, reduced, 1))
        setattr(self, names[1], Float32Conv(reduced, c, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        reduce, expand = (getattr(self, n) for n in self.names)
        se = expand(self.act(reduce(x.mean((2, 3), keepdim=True))))
        return x * torch.sigmoid(se)


def timm_trunk_class(backbone: str):
    """(trunk class, arch) of a ``timm_*`` backbone name; any other name
    raises as the JAX package's model does."""
    from tubedetr_tpu_torch.models import convnext, efficientnet, regnet

    arch = backbone[len("timm_"):]
    families = ((efficientnet.VARIANTS, efficientnet.EfficientNet),
                (regnet.REGNET_CFGS, regnet.RegNet),
                (convnext.CONVNEXT_CFGS, convnext.ConvNeXt))
    for table, cls in families:
        if arch in table:
            return cls, arch
    names = (sorted(efficientnet.VARIANTS) + sorted(regnet.REGNET_CFGS)
             + sorted(convnext.CONVNEXT_CFGS))
    raise NotImplementedError(f"timm backbone {arch!r} not available; supported: {names} "
                              "or resnet50/101/152[-gn]")
