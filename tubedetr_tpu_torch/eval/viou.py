"""vIoU evaluation for VidSTG and HC-STVG, host-side numpy (the port's copy of ``tubedetr_tpu/eval/viou.py``).

Per video:

* tIoU of the predicted against the GT ``[start, end)`` segment;
* vIoU, the per-frame box IoU summed over the frames in pred ∩ GT and
  divided by the number of frames in pred ∪ GT;
* vIoU@R, recall at the thresholds (0.3, 0.5);
* gt_vIoU, the spatial-only bound over the GT moment.

``summarize`` averages them per question type (VidSTG's declarative and
interrogative; HC-STVG has only declarative).
"""

from __future__ import annotations

import os
import pickle
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import numpy as np

from tubedetr_tpu_torch.core.boxes import np_box_iou
from tubedetr_tpu_torch.data.annotations import VideoAnnotation

_SHARD_KEYS = ("predictions", "video_predictions", "tsa_weights", "text_weights",
               "spatial_weights", "pred_sted_logits")


class VIoUEvaluator:
    """Accumulates per-frame box predictions and per-video segments, then
    scores them against the annotations."""

    def __init__(
        self,
        annotations: List[VideoAnnotation],
        iou_thresholds=(0.3, 0.5),
        tmp_loc: bool = True,
        save_pred: bool = False,
    ):
        self.anns = {a.video_id: a for a in annotations}
        self.iou_thresholds = list(iou_thresholds)
        self.tmp_loc = tmp_loc
        self.save_pred = save_pred
        self.predictions: Dict[str, Dict] = {}  # "videoid_frameid" -> {"boxes"}
        self.video_predictions: Dict = {}  # video_id -> {"sted", "qtype"}
        self.tsa_weights: Dict = {}
        self.text_weights: Dict = {}
        self.spatial_weights: Dict = {}
        self.pred_sted_logits: Dict = {}
        self.results = None

    # -- accumulation ----------------------------------------------------
    def update(self, predictions: Dict[str, Dict]):
        self.predictions.update(predictions)

    def video_update(self, video_predictions: Dict):
        self.video_predictions.update(video_predictions)

    def save(self, tsa, text_w, spatial_w, sted_logits, video_ids):
        """Keep each video's attention weights and sted logits, for a
        ``--test`` run's inspection."""
        for i, vid in enumerate(video_ids):
            self.tsa_weights[vid] = np.asarray(tsa[i]).tolist()
            self.text_weights[vid] = np.asarray(text_w[i]).tolist()
            self.spatial_weights[vid] = np.asarray(spatial_w[i]).tolist()
            self.pred_sted_logits[vid] = np.asarray(sted_logits[i]).tolist()

    # -- multi-process merge ---------------------------------------------
    def synchronize_between_processes(
        self,
        sync_dir: str = "",
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
        barrier: Optional[Callable[[], None]] = None,
    ):
        """Merge the prediction dicts of several processes through files:
        each writes its shard to ``sync_dir`` (shared storage), waits at
        ``barrier``, then reads every other shard, and waits again before
        the next merge may rewrite the shards. The defaults are the
        ``torch.distributed`` process group's rank, size and
        ``dist.barrier``; without a process group (one process) it is a
        no-op."""
        from tubedetr_tpu_torch.parallel import dist as tdist

        if process_count is None:
            process_count = tdist.get_world_size()
        if process_count == 1:
            return
        if process_index is None and barrier is None and tdist.is_dist_initialized():
            process_index, barrier = tdist.get_rank(), tdist.barrier
        if process_index is None or barrier is None:
            raise ValueError(
                "a multi-process merge needs process_index, process_count and barrier"
            )
        if not sync_dir:
            raise ValueError("a multi-process merge needs sync_dir on shared storage")
        os.makedirs(sync_dir, exist_ok=True)
        tmp = os.path.join(sync_dir, f"shard_{process_index}.pkl.tmp")
        with open(tmp, "wb") as f:
            pickle.dump({k: getattr(self, k) for k in _SHARD_KEYS}, f)
        os.replace(tmp, os.path.join(sync_dir, f"shard_{process_index}.pkl"))
        barrier()
        for i in range(process_count):
            if i == process_index:
                continue
            path = os.path.join(sync_dir, f"shard_{i}.pkl")
            deadline = time.time() + 60  # tolerate shared-storage visibility lag
            while not os.path.exists(path) and time.time() < deadline:
                time.sleep(0.2)
            with open(path, "rb") as f:
                other = pickle.load(f)
            for k in _SHARD_KEYS:
                getattr(self, k).update(other[k])
        barrier()

    # -- scoring ---------------------------------------------------------
    def evaluate(self) -> Dict:
        vid_metrics = {}
        for video_id, vpred in self.video_predictions.items():
            ann = self.anns[video_id]
            m: Dict = {"qtype": vpred.get("qtype", ann.qtype), "img_metrics": {}}

            if self.tmp_loc:
                gt_sted = (ann.tube_start_frame, ann.tube_end_frame)
                pred_sted = vpred["sted"]
                max_start = max(gt_sted[0], pred_sted[0])
                min_end = min(gt_sted[1], pred_sted[1])
                min_start = min(gt_sted[0], pred_sted[0])
                max_end = max(gt_sted[1], pred_sted[1])
                if min_end <= max_start:
                    tiou = 0.0
                else:
                    inter = min_end - max_start
                    union = (gt_sted[1] - gt_sted[0]) + (pred_sted[1] - pred_sted[0]) - inter
                    tiou = inter / union
                m.update({"gt_sted": list(gt_sted), "pred_sted": list(pred_sted),
                          "tiou": float(tiou)})
                union_predgt = [f for f in ann.frame_ids if min_start <= f < max_end]
                inter_predgt = {f for f in ann.frame_ids if max_start <= f < min_end}
            else:
                union_predgt = ann.frame_ids
                inter_predgt = set(ann.frame_ids)

            viou, gt_viou = 0.0, 0.0
            for fid in ann.inter_frames:
                key = f"{video_id}_{fid}"
                if key not in self.predictions:
                    raise RuntimeError(f"missing prediction for frame {key}")
                pred_box = np.asarray(self.predictions[key]["boxes"]).reshape(1, 4)
                x, y, w, h = ann.boxes_xywh[fid]
                gt_box = np.array([[x, y, x + w, y + h]])
                iou = float(np_box_iou(pred_box, gt_box)[0, 0])
                m["img_metrics"][key] = {"iou": iou, "pred_box": pred_box[0].tolist(),
                                         "gt_box": gt_box[0].tolist()}
                if self.tmp_loc and fid in inter_predgt:
                    viou += iou
                gt_viou += iou

            if self.tmp_loc:
                viou = viou / max(len(union_predgt), 1)
                m["viou"] = viou
                for th in self.iou_thresholds:
                    m[f"viou@{th}"] = float(viou > th)
            gt_viou = gt_viou / max(len(ann.inter_frames), 1)
            m["gt_viou"] = gt_viou
            for th in self.iou_thresholds:
                m[f"gt_viou@{th}"] = float(gt_viou > th)
            vid_metrics[video_id] = m
        return vid_metrics

    def summarize(self) -> Optional[Dict]:
        """Every metric averaged per question type, as ``{qtype}_{metric}``."""
        self.results = self.evaluate()
        sums = defaultdict(lambda: defaultdict(float))
        counts = defaultdict(int)
        keys = ["gt_viou"] + [f"gt_viou@{t}" for t in self.iou_thresholds]
        if self.tmp_loc:
            keys += ["tiou", "viou"] + [f"viou@{t}" for t in self.iou_thresholds]
        for m in self.results.values():
            counts[m["qtype"]] += 1
            for k in keys:
                sums[m["qtype"]][k] += m[k]
        out = {f"{q}_{k}": v / counts[q] for q in sums for k, v in sums[q].items()}
        if self.save_pred:
            out["predictions"] = self.predictions
            out["video_predictions"] = self.video_predictions
            out["vid_metrics"] = self.results
            if self.tsa_weights:
                out["tsa_weights"] = self.tsa_weights
                out["text_weights"] = self.text_weights
                out["spatial_weights"] = self.spatial_weights
                out["pred_sted"] = self.pred_sted_logits
        return out
