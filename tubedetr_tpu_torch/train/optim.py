"""Optimizer, LR schedules, gradient clipping and EMA (counterpart of ``tubedetr_tpu/train/optim.py``).

* Three LR groups: the transformer and heads (``lr``), the visual trunk
  (``lr_backbone``) and the text encoder (``text_encoder_lr``). Frozen
  parameters (``requires_grad`` off: the stem and layer1 always, the trunk
  under ``freeze_backbone`` or ``lr_backbone <= 0``, the text encoder under
  ``freeze_text_encoder``) join no group and carry no gradient, so they
  stay out of the clip norm, as the JAX package's ``mask_frozen_grads``
  arranges.
* The four per-step schedules of ``adjust_learning_rate`` as multipliers of
  (epoch, step); the step sets each group's LR (``set_lrs``).
* ``clip_grad_norm``: ``optax.clip_by_global_norm``'s rule, ``g * max_norm /
  norm`` once ``norm >= max_norm`` (no ``+1e-6``, unlike
  ``torch.nn.utils.clip_grad_norm_``); ``clip_max_norm = 0`` disables it.
* EMA over every parameter: ``ema = ema * decay + (1 - decay) * w``.
"""

from __future__ import annotations

from bisect import bisect_right
from typing import Dict, List, NamedTuple

import torch
from torch import nn

from tubedetr_tpu_torch.config import TubeDETRConfig

GROUP_LR = {"main": "lr", "backbone": "lr_backbone", "text": "lr_text_encoder"}


class LRSchedule(NamedTuple):
    """Multipliers of the three groups' base LRs at one step."""

    main: float
    backbone: float
    text: float


def schedule_gammas(cfg: TubeDETRConfig, epoch: int, curr_step: int,
                    num_training_steps: int) -> LRSchedule:
    """The multipliers of (lr, lr_backbone, text_encoder_lr) at (epoch, step)."""
    num_warmup = round(cfg.fraction_warmup_steps * num_training_steps)

    def linear_warmup_decay():
        if curr_step < num_warmup:
            return float(curr_step) / float(max(1, num_warmup))
        return max(0.0, float(num_training_steps - curr_step)
                   / float(max(1, num_training_steps - num_warmup)))

    if cfg.schedule == "step":
        gamma = 0.1 ** (epoch // cfg.lr_drop)
        text_gamma = gamma
    elif cfg.schedule == "multistep":
        milestones = list(range(cfg.lr_drop, cfg.epochs, 50))
        gamma = 0.5 ** bisect_right(milestones, epoch)
        text_gamma = gamma
    elif cfg.schedule == "linear_with_warmup":
        gamma = 0.1 ** (epoch // cfg.lr_drop)
        text_gamma = linear_warmup_decay()
    elif cfg.schedule == "all_linear_with_warmup":
        text_gamma = linear_warmup_decay()
        gamma = text_gamma
    else:
        raise NotImplementedError(cfg.schedule)
    return LRSchedule(gamma, gamma, text_gamma)


def current_lrs(cfg: TubeDETRConfig, epoch: int, curr_step: int,
                num_training_steps: int) -> Dict[str, float]:
    g = schedule_gammas(cfg, epoch, curr_step, num_training_steps)
    return {
        "lr": cfg.lr * g.main,
        "lr_backbone": cfg.lr_backbone * g.backbone,
        "lr_text_encoder": cfg.text_encoder_lr * g.text,
    }


def base_lrs(cfg: TubeDETRConfig) -> Dict[str, float]:
    return {"lr": cfg.lr, "lr_backbone": cfg.lr_backbone, "lr_text_encoder": cfg.text_encoder_lr}


def label_params(model: nn.Module) -> Dict[str, str]:
    """Parameter name -> 'main', 'backbone', 'text' or 'frozen'."""

    def label(name: str, p: nn.Parameter) -> str:
        if not p.requires_grad:
            return "frozen"
        if name.startswith("backbone."):
            return "backbone"
        if name.startswith("transformer.text_encoder."):
            return "text"
        return "main"

    return {name: label(name, p) for name, p in model.named_parameters()}


def build_optimizer(cfg: TubeDETRConfig, model: nn.Module):
    """AdamW (betas 0.9/0.999, eps 1e-8, decoupled weight decay on every
    trainable parameter) or SGD with momentum 0.9, one param group a label;
    each group's ``lr`` is set a step by ``set_lrs``. Returns (optimizer,
    labels)."""
    labels = label_params(model)
    groups = []
    for group in GROUP_LR:
        params = [p for n, p in model.named_parameters() if labels[n] == group]
        if params:
            groups.append({"params": params, "group": group})
    if cfg.optimizer == "sgd":
        opt = torch.optim.SGD(groups, lr=0.0, momentum=0.9)
    else:
        opt = torch.optim.AdamW(groups, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=cfg.weight_decay)
    return opt, labels


def set_lrs(optimizer: torch.optim.Optimizer, lrs: Dict[str, float]) -> None:
    for g in optimizer.param_groups:
        g["lr"] = float(lrs[GROUP_LR[g["group"]]])


def clip_grad_norm(params: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale the gradients that exist by ``max_norm / norm`` when their
    global L2 norm is ``>= max_norm`` (``optax.clip_by_global_norm``);
    returns the norm before the clip, in float32."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    norm = torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))
    if max_norm > 0 and float(norm) >= max_norm:
        for g in grads:
            g.copy_(g / norm.to(g.dtype) * max_norm)
    return norm


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor], decay: float) -> None:
    """``ema[k] = ema[k] * decay + (1 - decay) * params[k]``, in place."""
    keys = list(ema)
    e = [ema[k] for k in keys]
    torch._foreach_mul_(e, decay)
    torch._foreach_add_(e, [params[k].detach() for k in keys], alpha=1.0 - decay)
