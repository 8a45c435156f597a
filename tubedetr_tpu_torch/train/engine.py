"""The train and evaluation epoch loops (counterpart of ``tubedetr_tpu/train/engine.py``).

``train_one_epoch`` drives the train step over ``(batch, meta)`` pairs,
sets the LRs a step (adjusted after the step, as the reference does: step 0
runs at the base LRs), stops the process on a non-finite loss and logs.
``evaluate`` runs the eval step, slices a padded tail away, reads the
winning query where ``nq_select`` asks, and feeds the boxes and segments to
the vIoU evaluator.

Across processes each loop waits at a barrier before its first step (the
ranks start together) and all-reduces its meters at the end
(``sync_meters_between_processes``): the stats it returns are the world's.
With ``TUBEDETR_PROFILE_DIR`` set, the first epoch traces a window of its
steps (``utils/misc.py:ProfileWindow``).
"""

from __future__ import annotations

import json
import math
import os
import sys
from typing import Dict, Iterable

import numpy as np
import torch

from tubedetr_tpu_torch.config import TubeDETRConfig, loss_weight_dict
from tubedetr_tpu_torch.losses.matcher import box_match_cost
from tubedetr_tpu_torch.models.postprocess import (
    postprocess_boxes,
    postprocess_sted,
    select_query_by_objectness,
    select_query_by_sted,
)
from tubedetr_tpu_torch.parallel.dist import barrier, sync_meters_between_processes
from tubedetr_tpu_torch.train.logging import MetricLogger
from tubedetr_tpu_torch.train.optim import base_lrs, current_lrs
from tubedetr_tpu_torch.utils.misc import ProfileWindow


def train_one_epoch(cfg: TubeDETRConfig, train_step, state, data_loader: Iterable, epoch: int,
                    num_training_steps: int, writer=None) -> tuple:
    """One epoch; returns (state, stats). A non-finite loss prints the
    terms and exits with status 1."""
    logger = MetricLogger(print_freq=100)
    weight_dict = loss_weight_dict(cfg)
    header = f"Epoch: [{epoch}]"
    n_steps_per_epoch = getattr(data_loader, "__len__", lambda: None)()
    profiler = ProfileWindow(enabled=epoch == 0)  # one bounded trace a run

    for i, (batch, meta) in enumerate(logger.log_every(data_loader, header)):
        profiler.step(i)
        curr_step = epoch * (n_steps_per_epoch or 0) + i
        # the reference adjusts the LRs after optimizer.step(): global step g
        # runs at the schedule of step g - 1, step 0 at the base LRs
        if curr_step == 0:
            lrs = base_lrs(cfg)
        else:
            prev_epoch = epoch if i > 0 else epoch - 1
            lrs = current_lrs(cfg, prev_epoch, curr_step - 1, num_training_steps)
        if i == 0:
            barrier(f"train_first_step_e{epoch}")
        state, metrics = train_step(state, batch, lrs, cfg.seed)
        loss_value = float(metrics["loss_total"])
        if not math.isfinite(loss_value):
            print(f"Loss is {loss_value}, stopping training")
            print({k: float(v) for k, v in metrics.items()})
            sys.exit(1)
        logger.update(
            loss=loss_value, lr=lrs["lr"], lr_backbone=lrs["lr_backbone"],
            lr_text_encoder=lrs["lr_text_encoder"],
            **{k: float(v) for k, v in metrics.items() if k in weight_dict or k.endswith("_unscaled")},
        )
        if writer is not None and i % 100 == 0:
            for k, v in metrics.items():
                writer.add_scalar(k, float(v), curr_step)
    profiler.close()  # a window the epoch was too short to fill
    sync_meters_between_processes(logger.meters)
    stats = {k: m.global_avg for k, m in logger.meters.items()}
    return state, stats


def _maybe_log_qsel(qsel, outputs, batch, meta):
    """With ``TUBEDETR_QSEL_LOG=<path>``, append one JSON line a clip: how
    often the selected query is the one the training match would pick (the
    argmin of the box cost at its default coefficients) on the annotated
    frames, per frame and for the video's one match."""
    path = os.environ.get("TUBEDETR_QSEL_LOG")
    if not path or "target_boxes" not in batch:
        return
    pred_q = torch.as_tensor(np.asarray(outputs["pred_boxes_queries"]))
    tgt = torch.as_tensor(np.asarray(batch["target_boxes"]))
    inter = np.asarray(batch["inter_idx"])
    cost = box_match_cost(pred_q, tgt).numpy()  # (B, T, nq)
    matched = cost.argmin(-1)
    qsel = np.asarray(qsel)
    per_frame_sel = qsel.ndim == 2  # objectness: (B, T) winners
    with open(path, "a") as f:
        for i in range(qsel.shape[0]):
            s0, e0 = int(inter[i, 0]), int(inter[i, 1])
            if s0 < 0:
                continue
            frames = matched[i, s0 : e0 + 1]
            video_q = int(cost[i, s0 : e0 + 1].sum(0).argmin())
            if per_frame_sel:
                sel = qsel[i, s0 : e0 + 1]
                row = {"selected": [int(q) for q in sel],
                       "agreement": float((frames == sel).mean()),
                       "video_agreement": float((sel == video_q).mean())}
            else:
                row = {"selected": int(qsel[i]),
                       "agreement": float((frames == int(qsel[i])).mean()),
                       "video_agreement": float(video_q == int(qsel[i]))}
            f.write(json.dumps({"video_id": str(meta["video_ids"][i]),
                                "matched": [int(q) for q in frames],
                                "matched_video": video_q, **row}) + "\n")


def _numpy(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def evaluate(cfg: TubeDETRConfig, eval_step, state, data_loader: Iterable, evaluator=None,
             dataset_name: str = "vidstg", test_mode: bool = False) -> Dict:
    """The evaluation epoch: model, boxes to pixels, logits to segments, the
    vIoU evaluator (``test_mode`` keeps every valid frame and stores the
    attention weights). Returns the mean of each loss."""
    logger = MetricLogger(print_freq=100)
    padded_losses = []
    for batch, meta in logger.log_every(data_loader, "Eval:"):
        outputs, losses = eval_step(state, batch)
        outputs = {k: _numpy(v) for k, v in outputs.items()}
        losses = {k: float(v) for k, v in losses.items() if v.dim() == 0}

        durations = _numpy(batch["durations"])
        time_mask = _numpy(batch["time_mask"]).astype(bool)
        inter = _numpy(batch["inter_idx"])
        # a batch padded to a static size (its last sample repeated) keeps
        # its real length in meta: slice the padded tail away
        b = durations.shape[0]
        padded = meta.get("video_ids") is not None and len(meta["video_ids"]) < b
        if padded:
            b = len(meta["video_ids"])
            durations, time_mask, inter = durations[:b], time_mask[:b], inter[:b]
            outputs = {k: v[:b] for k, v in outputs.items()}
        if losses and not padded:
            logger.update(**losses)
        elif losses:  # the repeated tail would count twice in the meters
            padded_losses.append(losses)

        if evaluator is None:
            continue

        if cfg.num_queries > 1 and cfg.nq_select == "sted" and "pred_sted_queries" in outputs:
            qsel = select_query_by_sted(outputs["pred_sted_queries"], time_mask, meta["video_ids"])
            _maybe_log_qsel(qsel, outputs, batch, meta)
            idx = qsel[:, None, None, None]
            outputs = dict(outputs)
            outputs["pred_boxes"] = np.take_along_axis(outputs["pred_boxes_queries"], idx, axis=2)[:, :, 0]
            outputs["pred_sted"] = np.take_along_axis(outputs["pred_sted_queries"], idx, axis=2)[:, :, 0]
        elif cfg.num_queries > 1 and cfg.nq_select == "objectness" and "pred_obj_queries" in outputs:
            qsel = select_query_by_objectness(outputs["pred_obj_queries"], time_mask)  # (B, T)
            _maybe_log_qsel(qsel, outputs, batch, meta)
            idx = qsel[:, :, None, None]
            outputs = dict(outputs)
            outputs["pred_boxes"] = np.take_along_axis(outputs["pred_boxes_queries"], idx, axis=2)[:, :, 0]
            if "pred_sted_queries" in outputs:
                outputs["pred_sted"] = np.take_along_axis(outputs["pred_sted_queries"], idx, axis=2)[:, :, 0]

        preds = {}
        for i in range(b):
            vid = meta["video_ids"][i]
            oh, ow = meta["orig_sizes"][i]
            boxes = postprocess_boxes(outputs["pred_boxes"][i], np.array([oh, ow]))  # (T, 4)
            s0, e0 = inter[i]
            frames = meta["frames_id"][i]
            if s0 < 0 and not test_mode:
                continue  # a clip that misses the moment
            lo = 0 if test_mode else int(s0)
            hi = int(durations[i]) if test_mode else int(e0) + 1
            for j in range(lo, min(hi, len(frames))):
                preds[f"{vid}_{frames[j]}"] = {"boxes": [boxes[j].tolist()]}
        evaluator.update(preds)

        if cfg.sted and "pred_sted" in outputs:
            steds = postprocess_sted(outputs["pred_sted"], meta["frames_id"], meta["video_ids"],
                                     time_mask)
            seen, vp = set(), {}
            for i, vid in enumerate(meta["video_ids"]):
                if vid in seen:
                    continue
                seen.add(vid)
                vp[vid] = {"sted": steds[len(vp)], "qtype": meta["qtypes"][i]}
            evaluator.video_update(vp)

        if test_mode and "weights" in outputs and hasattr(evaluator, "save"):
            ca = outputs["ca_weights"]  # (B, T, hw + L): spatial, then text
            hw = ca.shape[-1] - _numpy(batch["text_pad_mask"]).shape[-1]
            evaluator.save(outputs["weights"], ca[..., hw:], ca[..., :hw], outputs["pred_sted"],
                           meta["video_ids"])
    if padded_losses and not logger.meters:
        print("[eval] all batches were padded; loss meters use padded-batch averages "
              "(repeated tail samples over-weighted)")
        for pl in padded_losses:
            logger.update(**pl)
    sync_meters_between_processes(logger.meters)
    return {k: m.global_avg for k, m in logger.meters.items()}
