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
* Under ZeRO-1 a rank's optimizer holds the parameters it owns
  (``build_optimizer(only=...)``); a checkpoint holds one process's layout,
  which ``named_optimizer_state`` and ``optimizer_state_dict`` convert
  from and to.
"""

from __future__ import annotations

from bisect import bisect_right
from typing import Dict, List, NamedTuple, Optional

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


def param_layout(labels: Dict[str, str], only=None) -> List[tuple]:
    """``[(group, [names])]``: the optimizer's parameter groups in order, one
    a label of ``GROUP_LR`` that has parameters (``labels`` in the model's
    parameter order), restricted to the names in ``only`` when given."""
    layout = []
    for group in GROUP_LR:
        names = [n for n, g in labels.items() if g == group and (only is None or n in only)]
        if names:
            layout.append((group, names))
    return layout


def build_optimizer(cfg: TubeDETRConfig, model: nn.Module, only=None):
    """AdamW (betas 0.9/0.999, eps 1e-8, decoupled weight decay on every
    trainable parameter) or SGD with momentum 0.9, one param group a label;
    each group's ``lr`` is set a step by ``set_lrs``. ``only`` (a set of
    names) keeps the parameters a ZeRO-1 rank owns. Returns (optimizer,
    labels)."""
    labels = label_params(model)
    params = dict(model.named_parameters())
    groups = [{"params": [params[n] for n in names], "group": group}
              for group, names in param_layout(labels, only)]
    if cfg.optimizer == "sgd":
        # a ZeRO rank may own nothing trainable: an optimizer needs a group
        opt = torch.optim.SGD(groups or [{"params": [], "group": "main"}], lr=0.0, momentum=0.9)
    else:
        opt = torch.optim.AdamW(groups or [{"params": [], "group": "main"}], lr=0.0,
                                betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.weight_decay)
    return opt, labels


def optimizer_names(optimizer: torch.optim.Optimizer, model: nn.Module) -> List[str]:
    """The parameter name of each of ``optimizer``'s positions."""
    name_of = {id(p): n for n, p in model.named_parameters()}
    return [name_of[id(p)] for g in optimizer.param_groups for p in g["params"]]


def named_optimizer_state(optimizer: torch.optim.Optimizer, names: List[str]):
    """(``{name: per-parameter state}``, ``{group: hyper-parameters}``) of
    ``optimizer``: its ``state_dict`` keyed by ``names`` (the name of each
    position, ``optimizer_names``) instead of positions."""
    sd = optimizer.state_dict()
    state = {names[i]: st for i, st in sd["state"].items()}
    hypers = {g["group"]: {k: v for k, v in g.items() if k != "params"} for g in sd["param_groups"]}
    return state, hypers


def optimizer_state_dict(state: Dict, hypers: Dict, labels: Dict[str, str]) -> Dict:
    """The ``state_dict`` of one process's optimizer (``build_optimizer``
    over every trainable parameter) from its state by name and its groups'
    hyper-parameters: the layout a one-process checkpoint holds."""
    out, groups, i = {}, [], 0
    for group, names in param_layout(labels):
        groups.append({**hypers[group], "params": list(range(i, i + len(names)))})
        for n in names:
            if n in state:
                out[i] = state[n]
            i += 1
    return {"state": out, "param_groups": groups}


def move_optimizer_state(old: torch.optim.Optimizer, old_names: List[str],
                         new: torch.optim.Optimizer, new_names: List[str],
                         convert=None) -> None:
    """Load into ``new`` the state ``old`` holds for ``new``'s parameters,
    matched by name (``*_names``: each position's), each tensor but the step
    count passed through ``convert(value, position)`` when given, and
    ``old``'s hyper-parameters of each group."""
    state, hypers = named_optimizer_state(old, old_names)
    if not state:
        return
    sd = new.state_dict()
    for i, n in enumerate(new_names):
        if n in state:
            sd["state"][i] = {k: (convert(v, i) if convert is not None and k != "step" else v)
                              for k, v in state[n].items()}
    for g in sd["param_groups"]:
        g.update(hypers.get(g["group"], {}))
    new.load_state_dict(sd)


def set_lrs(optimizer: torch.optim.Optimizer, lrs: Dict[str, float]) -> None:
    for g in optimizer.param_groups:
        g["lr"] = float(lrs[GROUP_LR[g["group"]]])


def _local(t: torch.Tensor) -> torch.Tensor:
    """A tensor's local part: an FSDP shard's own elements (``to_local``,
    sharing storage), any other tensor itself."""
    return t.to_local() if hasattr(t, "to_local") else t


def clip_grad_norm(params: List[torch.Tensor], max_norm: float, shard_group=None,
                   split: Optional[List[bool]] = None, model_group=None) -> torch.Tensor:
    """Scale the gradients that exist by ``max_norm / norm`` when their
    global L2 norm is ``>= max_norm`` (``optax.clip_by_global_norm``);
    returns the norm before the clip, in float32. Gradients sharded by FSDP
    (DTensors) hold a share of their elements a rank: their squares are
    summed over ``shard_group`` (the data ranks). ``split`` marks the
    parameters that are tensor-parallel slices (``parallel/tp.py``): their
    squares are then summed over ``model_group`` too; every other gradient
    is the same on each model rank and counted once."""
    import torch.distributed as dist

    keep = [i for i, p in enumerate(params) if p.grad is not None]
    grads = [params[i].grad for i in keep]
    if not grads:
        return torch.zeros(())
    sq = [torch.sum(_local(g).float() * _local(g).float()) for g in grads]
    sharded = [hasattr(g, "to_local") for g in grads]
    sliced = [False] * len(grads) if split is None else [split[i] for i in keep]
    zero = torch.zeros((), dtype=torch.float32, device=sq[0].device)

    def total(fsdp: bool, tp: bool):
        return sum((s for s, sh, t in zip(sq, sharded, sliced) if sh == fsdp and t == tp), zero)

    fsdp = torch.stack([total(True, True), total(True, False)])
    if any(sharded):
        dist.all_reduce(fsdp, group=shard_group)
    tp = fsdp[0] + total(False, True)
    if model_group is not None:
        dist.all_reduce(tp, group=model_group)
    norm = torch.sqrt(tp + fsdp[1] + total(False, False))
    if max_norm > 0 and float(norm) >= max_norm:
        for g in grads:
            g = _local(g)
            g.copy_(g / norm.to(g.dtype) * max_norm)
    return norm


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor], decay: float) -> None:
    """``ema[k] = ema[k] * decay + (1 - decay) * params[k]``, in place; on
    an FSDP shard, over the rank's own elements."""
    keys = list(ema)
    e = [_local(ema[k]) for k in keys]
    torch._foreach_mul_(e, decay)
    torch._foreach_add_(e, [_local(params[k].detach()) for k in keys], alpha=1.0 - decay)
