"""TubeDETR losses, mask-based and batched (counterpart of ``tubedetr_tpu/losses/criterion.py``).

Predictions stay on static ``(B, T)`` grids and the in-moment frames are
weighted by a ``positive_map`` (``inter_positive_map & time_mask``) instead
of being gathered. With ``num_queries = 1`` predictions align with the
per-frame targets; with more, each decoder layer matches one query per frame
(or per video, ``nq_match="video"``) on a cost computed without gradients,
and an objectness BCE trains the match.

``num_boxes`` is the number of annotated frames of the whole batch; under
gradient accumulation the train step passes the full batch's count to every
microbatch, and ``mean_scale`` (``1 / grad_accum``) scales the batch-mean
losses, so that the microbatch sums equal the big batch's losses. Across
data-parallel ranks ``num_boxes`` is the ranks' total and ``sum_scale``
(their count) scales the box and objectness sums, so that the mean over the
ranks, which DDP takes of the gradients, is the global batch's loss (the
JAX package writes the loss over the global batch).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from tubedetr_tpu_torch.config import TubeDETRConfig, loss_weight_dict
from tubedetr_tpu_torch.core.boxes import box_cxcywh_to_xyxy, paired_generalized_box_iou
from tubedetr_tpu_torch.core.masking import inter_positive_map
from tubedetr_tpu_torch.losses.matcher import box_match_cost, match_single_target

Losses = Dict[str, torch.Tensor]


def loss_boxes(pred_boxes, target_boxes, positive_map, num_boxes) -> Losses:
    """L1 and 1 - GIoU on the in-moment frames, over ``num_boxes``.
    pred/target (B, T, 4) cxcywh; positive_map (B, T) bool."""
    w = positive_map.to(pred_boxes.dtype)
    denom = torch.clamp(torch.as_tensor(num_boxes, dtype=pred_boxes.dtype), min=1.0)
    l1 = (pred_boxes - target_boxes).abs().sum(-1)
    giou = paired_generalized_box_iou(box_cxcywh_to_xyxy(pred_boxes), box_cxcywh_to_xyxy(target_boxes))
    return {"loss_bbox": (l1 * w).sum() / denom, "loss_giou": ((1.0 - giou) * w).sum() / denom}


def loss_sted(pred_sted, inter_idx, time_mask, sigma: float = 1.0) -> Losses:
    """KL(pred || quantized Gaussian of width ``sigma`` about the GT start and
    end) over the valid frames; padded logits get -1e32 before the softmax.
    The mean runs over all B*T positions, as the reference's ``.mean()``."""
    t = pred_sted.shape[1]
    eps = 1e-6
    sted = torch.where(time_mask[:, :, None], pred_sted, torch.full_like(pred_sted, -1e32))
    ar = torch.arange(t, dtype=torch.float32, device=pred_sted.device)[None]
    valid = time_mask.to(pred_sted.dtype)

    def kl(logits, center):
        target = torch.exp(-((ar - center[:, None].float()) ** 2) / (2 * sigma ** 2)) + eps
        target = target / target.sum(-1, keepdim=True)
        pred = torch.exp(logits - logits.amax(-1, keepdim=True))
        pred = pred / pred.sum(-1, keepdim=True)
        return pred * torch.log((pred + eps) / target) * valid

    total = kl(sted[:, :, 0], inter_idx[:, 0]) + kl(sted[:, :, 1], inter_idx[:, 1])
    return {"loss_sted": total.mean()}


def loss_guided_attn(weights, positive_map, time_mask) -> Losses:
    """-log(1 - w) of the TSA weights (B, T, T) on the rows of frames outside
    the moment; each row's sum over keys is divided by the video's count of
    such frames."""
    eps = 1e-6
    pos_or_pad = positive_map | ~time_mask
    # (1 + eps) - w: XLA folds the JAX package's (1 - w) + eps so, which
    # shows where w is 1 (the one key of --no_tsa): float32 1 + eps is 1 + 2^-20
    loss = -torch.log((1.0 + eps) - weights)
    loss = torch.where(pos_or_pad[:, :, None], torch.zeros_like(loss), loss)
    nb_neg = (~pos_or_pad).sum(1).to(loss.dtype) + eps
    return {"loss_guided_attn": (loss.sum(2) / nb_neg[:, None]).sum(1).mean()}


class SetCriterion:
    """The per-layer losses and their aux expansion (``loss_weight_dict``)."""

    def __init__(self, cfg: TubeDETRConfig):
        self.cfg = cfg
        self.weight_dict = loss_weight_dict(cfg)

    def __call__(self, outputs: Dict[str, torch.Tensor], target_boxes, inter_idx, time_mask,
                 num_boxes: Optional[torch.Tensor] = None, mean_scale: float = 1.0,
                 sum_scale: float = 1.0) -> Losses:
        cfg = self.cfg
        positive_map = inter_positive_map(inter_idx, time_mask.shape[1]) & time_mask
        if num_boxes is None:
            num_boxes = positive_map.sum().float()

        def match(pred_boxes_q, pred_sted_q):
            with torch.no_grad():
                cost = box_match_cost(pred_boxes_q, target_boxes, cfg.bbox_loss_coef,
                                      cfg.giou_loss_coef)  # (B, T, nq)
                if cfg.nq_match == "video":  # one query for every frame of a video
                    cost_v = (cost * positive_map[..., None]).sum(dim=1)
                    qi = match_single_target(cost_v)[:, None].expand(cost.shape[:2])
                else:
                    qi = match_single_target(cost)
            idx = qi[..., None, None]
            pb = torch.gather(pred_boxes_q, 2, idx.expand(-1, -1, 1, 4))[:, :, 0]
            ps = None
            if pred_sted_q is not None:
                ps = torch.gather(pred_sted_q, 2, idx.expand(-1, -1, 1, 2))[:, :, 0]
            return pb, ps, qi

        def objectness_loss(pred_obj_q, qi):
            """BCE of every query's objectness logit on the annotated frames:
            the matched query positive, the others negative."""
            nq = pred_obj_q.shape[-1]
            onehot = (qi[..., None] == torch.arange(nq, device=qi.device)).to(pred_obj_q.dtype)
            x = pred_obj_q
            bce = torch.clamp(x, min=0.0) - x * onehot + torch.log1p(torch.exp(-x.abs()))
            w = positive_map.to(bce.dtype)
            denom = torch.clamp(torch.as_tensor(num_boxes, dtype=bce.dtype), min=1.0)
            return scaled({"loss_objectness": (bce.mean(-1) * w).sum() / denom})

        def scaled(d):
            return d if sum_scale == 1 else {k: v * sum_scale for k, v in d.items()}

        def layer_losses(pred_boxes, pred_sted, weights):
            d = scaled(loss_boxes(pred_boxes, target_boxes, positive_map, num_boxes))
            if cfg.sted and pred_sted is not None:
                d.update({k: v * mean_scale for k, v in
                          loss_sted(pred_sted, inter_idx, time_mask, cfg.sigma).items()})
            if cfg.guided_attn and weights is not None:
                d.update({k: v * mean_scale for k, v in
                          loss_guided_attn(weights, positive_map, time_mask).items()})
            return d

        multi_query = "pred_boxes_queries" in outputs
        if multi_query:
            pb, ps, qi = match(outputs["pred_boxes_queries"], outputs.get("pred_sted_queries"))
            losses = layer_losses(pb, ps, outputs.get("weights"))
            if "pred_obj_queries" in outputs:
                losses.update(objectness_loss(outputs["pred_obj_queries"], qi))
        else:
            losses = layer_losses(outputs["pred_boxes"], outputs.get("pred_sted"),
                                  outputs.get("weights"))
        if cfg.aux_loss and "aux_pred_boxes" in outputs:
            for i in range(outputs["aux_pred_boxes"].shape[0]):
                sted = outputs["aux_pred_sted" + ("_queries" if multi_query else "")][i] if cfg.sted else None
                weights = outputs["aux_weights"][i] if cfg.guided_attn else None
                if multi_query:
                    pb, ps, qi = match(outputs["aux_pred_boxes_queries"][i], sted)
                    d = layer_losses(pb, ps, weights)
                    if "aux_pred_obj_queries" in outputs:
                        d.update(objectness_loss(outputs["aux_pred_obj_queries"][i], qi))
                else:
                    d = layer_losses(outputs["aux_pred_boxes"][i], sted, weights)
                losses.update({f"{k}_{i}": v for k, v in d.items()})
        return losses

    def total(self, losses: Losses) -> torch.Tensor:
        return sum(losses[k] * w for k, w in self.weight_dict.items() if k in losses)
