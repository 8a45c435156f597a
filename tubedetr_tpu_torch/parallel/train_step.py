"""The training and evaluation steps (counterpart of ``tubedetr_tpu/parallel/train_step.py``).

A training step: the forward with the training backbone semantics
(``TubeDETR.forward(train=True)``) and the losses, the backward,
``--grad_accum`` equal microbatches (each backward adds into ``.grad``; the
box losses share the whole batch's ``num_boxes`` and the batch-mean losses
are scaled by ``1 / grad_accum``, so the sum equals the big batch's step),
the clip at ``clip_max_norm`` over the parameters that have a gradient, the
optimizer at the step's per-group LRs, and the EMA. Dropout is on unless
the step is ``deterministic``, and draws from a generator seeded from the
dropout seed and the step number. ``TrainStep``'s three phases are public so
that a caller can time them apart.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from tubedetr_tpu_torch.config import TubeDETRConfig
from tubedetr_tpu_torch.core.masking import inter_positive_map
from tubedetr_tpu_torch.data import collate
from tubedetr_tpu_torch.losses.criterion import SetCriterion
from tubedetr_tpu_torch.models.layers import dropout_generator
from tubedetr_tpu_torch.train.optim import build_optimizer, clip_grad_norm, ema_update, set_lrs
from tubedetr_tpu_torch.utils.device import configure_precision

TARGETS = ("target_boxes", "inter_idx", "time_mask")


@dataclass
class TrainState:
    """The model (its parameters are the state), its optimizer, the labels
    of its parameters, the EMA parameters (or None) and the step count."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    labels: Dict[str, str]
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    step: int = 0

    def trainable(self):
        return [p for p in self.model.parameters() if p.requires_grad]


def create_train_state(cfg: TubeDETRConfig, model: nn.Module) -> TrainState:
    """The state that trains ``model``; on the card, float32 without TF32."""
    cfg.validate_training()
    configure_precision(next(model.parameters()).device)
    optimizer, labels = build_optimizer(cfg, model)
    ema = ({n: p.detach().clone() for n, p in model.named_parameters()} if cfg.ema else None)
    return TrainState(model, optimizer, labels, ema)


def expand_pad_masks(valid_hw: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, T, 2) valid extents -> (B, T, h, w) bool pad mask, True = pad
    (what ``collate`` builds densely without ``compact_pad_masks``)."""
    ih = torch.arange(h, device=valid_hw.device)[:, None]
    iw = torch.arange(w, device=valid_hw.device)[None, :]
    vh = valid_hw[..., 0][..., None, None]
    vw = valid_hw[..., 1][..., None, None]
    return ~((ih < vh) & (iw < vw))


def model_inputs(batch: Dict) -> Dict:
    """``TubeDETR.forward``'s keyword arguments from a batch, the dense pad
    masks rebuilt from ``{fast,slow}_valid_hw`` where the batch has those."""
    out = collate.model_inputs(batch)
    for stream in ("slow", "fast"):
        if f"{stream}_valid_hw" in batch and f"{stream}_pad_mask" not in out:
            frames = out[f"frames_{stream}"]
            out[f"{stream}_pad_mask"] = expand_pad_masks(
                batch[f"{stream}_valid_hw"], frames.shape[2], frames.shape[3]
            )
    return out


def to_device(batch: Dict, device: torch.device) -> Dict:
    """Every numpy array and tensor of ``batch`` as a tensor on ``device``."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(v)
        out[k] = v.to(device) if torch.is_tensor(v) else v
    return out


def dropout_seed_for(seed: int, step: int) -> int:
    """The dropout generator's seed at ``step``, as JAX folds the step into
    the seed's key (``fold_in``): both mixed into 32 bits, the part of a
    seed that the CPU generator reads."""
    return int(np.random.SeedSequence([int(seed), int(step)]).generate_state(1)[0])


class TrainStep:
    """``step(state, batch, lrs, dropout_seed) -> (state, metrics)``.
    ``metrics`` holds each loss term (summed over the microbatches),
    ``loss_total`` and ``grad_norm``, the norm before the clip."""

    def __init__(self, cfg: TubeDETRConfig, deterministic: bool = False):
        self.cfg = cfg
        self.criterion = SetCriterion(cfg)
        self.deterministic = deterministic

    def forward_loss(self, state: TrainState, batch: Dict, num_boxes=None, mean_scale: float = 1.0):
        """(total, losses) of one (micro)batch already on the model's device."""
        outputs = state.model(**model_inputs(batch), train=True)
        losses = self.criterion(outputs, *(batch[k] for k in TARGETS), num_boxes=num_boxes,
                                mean_scale=mean_scale)
        return self.criterion.total(losses), losses

    def backward(self, total: torch.Tensor) -> None:
        total.backward()

    def update(self, state: TrainState, lrs: Dict[str, float]) -> torch.Tensor:
        """Clip, the optimizer step and the EMA; returns the pre-clip norm."""
        params = state.trainable()
        norm = clip_grad_norm(params, self.cfg.clip_max_norm)
        set_lrs(state.optimizer, lrs)
        state.optimizer.step()
        if state.ema_params is not None:
            ema_update(state.ema_params, dict(state.model.named_parameters()), self.cfg.ema_decay)
        # int8 weights cached from the old float weights must not outlive them
        state.model.backbone[0].body.clear_int8_cache()
        state.step += 1
        return norm

    def generator(self, state: TrainState, dropout_seed: int, device) -> torch.Generator:
        gen = torch.Generator(device=device)
        gen.manual_seed(dropout_seed_for(dropout_seed, state.step))
        return gen

    def __call__(self, state: TrainState, batch: Dict, lrs: Dict[str, float], dropout_seed: int):
        model = state.model
        device = next(model.parameters()).device
        batch = to_device(batch, device)
        model.train(not self.deterministic)
        state.optimizer.zero_grad(set_to_none=True)
        accum = max(int(self.cfg.grad_accum), 1)
        with dropout_generator(self.generator(state, dropout_seed, device)):
            if accum == 1:
                total, losses = self.forward_loss(state, batch)
                self.backward(total)
                total, losses = total.detach(), {k: v.detach() for k, v in losses.items()}
            else:
                t = batch["time_mask"].shape[1]
                num_boxes = (inter_positive_map(batch["inter_idx"], t) & batch["time_mask"]).sum().float()
                n = batch["time_mask"].shape[0] // accum
                total, losses = 0.0, {}
                for i in range(accum):
                    micro = {k: v[i * n:(i + 1) * n] if torch.is_tensor(v) else v
                             for k, v in batch.items()}
                    mt, ml = self.forward_loss(state, micro, num_boxes, 1.0 / accum)
                    self.backward(mt)
                    total = total + mt.detach()
                    for k, v in ml.items():
                        losses[k] = losses.get(k, 0.0) + v.detach()
        norm = self.update(state, lrs)
        model.eval()
        metrics = dict(losses)
        metrics["loss_total"] = total
        metrics["grad_norm"] = norm
        return state, metrics


def make_train_step(cfg: TubeDETRConfig, deterministic: bool = False) -> TrainStep:
    """``deterministic`` turns dropout off (the parity tests' dropout-free
    step); training keeps it on."""
    return TrainStep(cfg, deterministic)


EVAL_KEYS = ("pred_boxes", "pred_sted", "weights", "ca_weights")
QUERY_KEYS = ("pred_boxes_queries", "pred_sted_queries", "pred_obj_queries")


@contextlib.contextmanager
def ema_weights(state: TrainState):
    """Inside, the model's parameters hold the EMA weights (each tensor's
    ``.data`` swapped, nothing copied; buffers named in ``ema_params`` too);
    a state without EMA leaves them as they are. Caches made from weights
    (the int8 weights and K2's folds) key on the tensor they were made
    from, so neither the EMA's nor the raw weights' cache serves the other."""
    if state.ema_params is None:
        yield
        return
    live = {**dict(state.model.named_buffers()), **dict(state.model.named_parameters())}
    saved = {n: live[n].data for n in state.ema_params}
    try:
        for n, t in state.ema_params.items():
            live[n].data = t
        yield
    finally:
        for n, t in saved.items():
            live[n].data = t


def make_eval_step(cfg: TubeDETRConfig, ema: bool = False):
    """``step(state, batch) -> (outputs, losses)``: the inference forward
    (``train=False``, dropout off), with the EMA parameters when ``ema`` and
    the state has them, and the losses when the batch has targets. The
    outputs are ``EVAL_KEYS``, plus the per-query heads that the query
    selectors of ``nq_select`` read."""
    criterion = SetCriterion(cfg)
    keep = EVAL_KEYS + (QUERY_KEYS if cfg.num_queries > 1 and cfg.nq_select in ("sted", "objectness")
                        else ())

    @torch.no_grad()
    def step_fn(state: TrainState, batch: Dict):
        model = state.model
        batch = to_device(batch, next(model.parameters()).device)
        model.eval()
        inputs = model_inputs(batch)
        with ema_weights(state) if ema else contextlib.nullcontext():
            outputs = model(**inputs)
        losses = {}
        if "target_boxes" in batch:
            losses = criterion(outputs, *(batch[k] for k in TARGETS))
        return {k: outputs[k] for k in keep if k in outputs}, losses

    return step_fn
