"""Hungarian matching for ``num_queries > 1`` training (the port's copy of ``tubedetr_tpu/losses/matcher.py``).

STVG has one target box per annotated frame, so the assignment of queries
to it is the argmin of the match cost over the queries
(``match_single_target``), which is the Hungarian optimum for one target.
``hungarian``, the rectangular solver, is kept as the oracle that choice is
tested against.
"""

from __future__ import annotations

import numpy as np
import torch

from tubedetr_tpu_torch.core.boxes import box_cxcywh_to_xyxy, paired_generalized_box_iou


def hungarian(cost: np.ndarray):
    """Exact minimum-cost assignment for a rectangular cost matrix.

    Returns ``(row_ind, col_ind)`` of length ``min(n_rows, n_cols)`` with
    ``cost[row_ind, col_ind].sum()`` minimal, the contract of
    ``scipy.optimize.linear_sum_assignment``: shortest augmenting paths with
    potentials, O(n^2 m), numpy only."""
    cost = np.asarray(cost, dtype=np.float64)
    transposed = cost.shape[0] > cost.shape[1]
    if transposed:
        cost = cost.T
    n, m = cost.shape  # n <= m

    inf = float("inf")
    u = np.zeros(n + 1)  # row potentials
    v = np.zeros(m + 1)  # column potentials
    p = np.zeros(m + 1, dtype=np.int64)  # p[j]: row matched to column j, 1-based
    way = np.zeros(m + 1, dtype=np.int64)

    for i in range(1, n + 1):
        p[0] = i
        j0 = 0
        minv = np.full(m + 1, inf)
        used = np.zeros(m + 1, dtype=bool)
        while True:
            used[j0] = True
            i0, delta, j1 = p[j0], inf, 0
            for j in range(1, m + 1):
                if used[j]:
                    continue
                cur = cost[i0 - 1, j - 1] - u[i0] - v[j]
                if cur < minv[j]:
                    minv[j] = cur
                    way[j] = j0
                if minv[j] < delta:
                    delta = minv[j]
                    j1 = j
            for j in range(m + 1):
                if used[j]:
                    u[p[j]] += delta
                    v[j] -= delta
                else:
                    minv[j] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        while j0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1

    row_of_col = p[1:]
    rows, cols = [], []
    for j in range(m):
        if row_of_col[j] > 0:
            rows.append(row_of_col[j] - 1)
            cols.append(j)
    rows, cols = np.asarray(rows), np.asarray(cols)
    order = np.argsort(rows)
    rows, cols = rows[order], cols[order]
    if transposed:
        return cols, rows
    return rows, cols


def match_single_target(cost: torch.Tensor) -> torch.Tensor:
    """``cost`` (..., n_queries) -> the min-cost query index (...,)."""
    return torch.argmin(cost, dim=-1)


def box_match_cost(pred_cxcywh: torch.Tensor, tgt_cxcywh: torch.Tensor,
                   bbox_coef: float = 5.0, giou_coef: float = 2.0) -> torch.Tensor:
    """``bbox_coef * L1 - giou_coef * GIoU`` between each query's box and the
    frame's target box, the loss's own weights. pred (..., nq, 4) cxcywh,
    tgt (..., 4) -> (..., nq)."""
    tgt = tgt_cxcywh[..., None, :]
    l1 = (pred_cxcywh - tgt).abs().sum(-1)
    giou = paired_generalized_box_iou(
        box_cxcywh_to_xyxy(pred_cxcywh), box_cxcywh_to_xyxy(tgt.expand_as(pred_cxcywh))
    )
    return bbox_coef * l1 + giou_coef * (-giou)
