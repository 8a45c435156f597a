"""Model outputs -> pixel boxes and temporal segments, on the host in numpy.

The port's copy of ``tubedetr_tpu/models/postprocess.py``: the box and
segment readouts, and the two query selectors of a ``num_queries > 1``
model (``--nq_select sted`` and ``--nq_select objectness``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def postprocess_boxes(
    pred_boxes: np.ndarray,  # (..., 4) cxcywh normalized
    target_sizes: np.ndarray,  # (..., 2) (h, w) original image sizes
) -> np.ndarray:
    """cxcywh in [0,1] -> xyxy pixels."""
    pred_boxes = np.asarray(pred_boxes, dtype=np.float64)
    cx, cy, w, h = np.moveaxis(pred_boxes, -1, 0)
    boxes = np.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], axis=-1)
    img_h = np.asarray(target_sizes)[..., 0]
    img_w = np.asarray(target_sizes)[..., 1]
    return boxes * np.stack([img_w, img_h, img_w, img_h], axis=-1)


def postprocess_sted(
    pred_sted: np.ndarray,  # (B, T, 2) start/end logits
    frames_id: Sequence[Sequence[int]],  # per-video real frame ids
    video_ids: Sequence,  # consecutive equal ids are clips of one video
    time_mask: np.ndarray,  # (B, T) True on VALID frames
) -> List[List[float]]:
    """Start/end logits -> [start_frame, end_frame) per video: the pair
    maximizing log p(start) + log p(end) with end > start, over the
    concatenated clips of each video; the end frame is exclusive."""
    pred_sted = np.asarray(pred_sted, dtype=np.float64)
    time_mask = np.asarray(time_mask, dtype=bool)
    _assert_clip_adjacency(video_ids)

    steds_list: List[np.ndarray] = []
    group_frames: List[List[int]] = []
    for i in range(pred_sted.shape[0]):
        masked = np.where(time_mask[i][:, None], pred_sted[i], -np.inf)
        valid_frames = list(frames_id[i])[: int(time_mask[i].sum())]
        if i > 0 and video_ids[i] == video_ids[i - 1]:
            steds_list[-1] = np.concatenate([steds_list[-1], masked], axis=0)
            group_frames[-1] = group_frames[-1] + valid_frames
        else:
            steds_list.append(masked)
            group_frames.append(valid_frames)

    results: List[List[float]] = []
    for sted, frames in zip(steds_list, group_frames):
        t = sted.shape[0]
        with np.errstate(invalid="ignore"):
            start_log = _log_softmax(sted[:, 0])
            end_log = _log_softmax(sted[:, 1])
        score = start_log[:, None] + end_log[None, :] + np.tril(np.full((t, t), -np.inf), k=0)
        s_idx, e_idx = np.unravel_index(np.nanargmax(score), score.shape)
        padded = frames + [0] * (t - len(frames))
        results.append([float(padded[s_idx]), float(padded[e_idx]) + 1.0])
    return results


def select_query_by_sted(
    pred_sted_q: np.ndarray,  # (B, T, nq, 2) per-query start/end logits
    time_mask: np.ndarray,  # (B, T) True on VALID frames
    video_ids: Sequence,  # consecutive equal ids are clips of one video
) -> np.ndarray:
    """One query a video, ranked by its own temporal-grounding confidence:
    query q scores the best ``log p(start) + log p(end)`` over valid
    ``start < end`` pairs of the video's clip-ensembled logits, the objective
    ``postprocess_sted`` then maximizes for the winner. Every clip (batch
    row) of a video shares the winner. Returns (B,) query indices."""
    pred_sted_q = np.asarray(pred_sted_q, dtype=np.float64)
    time_mask = np.asarray(time_mask, dtype=bool)
    b, _, nq, _ = pred_sted_q.shape
    _assert_clip_adjacency(video_ids)

    groups: List[List[int]] = []
    for i in range(b):
        if i > 0 and video_ids[i] == video_ids[i - 1]:
            groups[-1].append(i)
        else:
            groups.append([i])

    out = np.zeros(b, dtype=np.int64)
    for rows in groups:
        sted = np.concatenate(
            [np.where(time_mask[i][:, None, None], pred_sted_q[i], -np.inf) for i in rows], axis=0
        )  # (Tg, nq, 2)
        t = sted.shape[0]
        tri = np.tril(np.full((t, t), -np.inf), k=0)
        conf = np.full(nq, -np.inf)
        for q in range(nq):
            if not np.isfinite(sted[:, q, 0]).any():
                continue  # every frame masked: no signal for this query
            with np.errstate(invalid="ignore"):
                start_log = _log_softmax(sted[:, q, 0])
                end_log = _log_softmax(sted[:, q, 1])
            conf[q] = np.nanmax(start_log[:, None] + end_log[None, :] + tri)
        out[rows] = int(np.argmax(conf)) if np.isfinite(conf).any() else 0
    return out


def select_query_by_objectness(
    pred_obj_q: np.ndarray,  # (B, T, nq) per-(frame, query) objectness logits
    time_mask: np.ndarray,  # (B, T) True on VALID frames
) -> np.ndarray:
    """One query a frame: the one the objectness head scores highest there.
    Masked frames read 0. Returns (B, T) query indices."""
    sel = np.asarray(pred_obj_q, dtype=np.float64).argmax(-1)
    return np.where(np.asarray(time_mask, dtype=bool), sel, 0).astype(np.int64)


def _assert_clip_adjacency(video_ids: Sequence) -> None:
    """Clips of one video must be batch-adjacent, or the grouping above
    silently mixes videos."""
    first_pos = {}
    for i, vid in enumerate(video_ids):
        if vid in first_pos and video_ids[i - 1] != vid:
            raise ValueError(
                f"clips of video {vid!r} are not batch-adjacent "
                f"(positions {first_pos[vid]} and {i})"
            )
        first_pos.setdefault(vid, i)


def _log_softmax(x: np.ndarray) -> np.ndarray:
    m = np.max(x[np.isfinite(x)]) if np.isfinite(x).any() else 0.0
    return x - m - np.log(np.exp(x - m).sum())


def build_postprocessors(dataset_name: str) -> Dict[str, object]:
    pp = {"bbox": postprocess_boxes}
    if dataset_name in ("vidstg", "hcstvg"):
        pp[dataset_name] = postprocess_sted
    return pp
