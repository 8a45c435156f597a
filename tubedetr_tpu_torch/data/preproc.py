"""One-time annotation converters and their CLI (the port's copy of ``tubedetr_tpu/data/preproc.py``).

The reference's ``preproc/`` scripts as functions (its HC-STVG scripts read
their config by attribute on a dict and fail as they are; these work):

    python -m tubedetr_tpu_torch.data.preproc vidor --vidor_path ... --ann_path ...
    python -m tubedetr_tpu_torch.data.preproc vidstg --ann_path ...
    python -m tubedetr_tpu_torch.data.preproc hcstvg --ann_path ... [--v2]

The output files are the reference's, so annotation files serve the JAX
package, the port and the reference alike.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
from typing import Dict


def preproc_vidor(vidor_path: str, ann_path: str) -> None:
    """VidOR per-video JSONs -> vidor_{training,validation}.json trajectory
    maps (xywh boxes keyed by tid and frame index)."""
    for split in ("training", "validation"):
        outs: Dict = {}
        split_dir = os.path.join(vidor_path, split)
        for subdir in sorted(os.listdir(split_dir)):
            sub = os.path.join(split_dir, subdir)
            for fname in sorted(os.listdir(sub)):
                with open(os.path.join(sub, fname)) as f:
                    annot = json.load(f)
                tid2cat = {
                    o["tid"]: o["category"] for o in annot["subject/objects"]
                }
                trajectories: Dict = {}
                for i_frame, frame_boxes in enumerate(annot["trajectories"]):
                    for bbox in frame_boxes:
                        tid = bbox["tid"]
                        trajectories.setdefault(tid, {})[i_frame] = {
                            "bbox": [
                                bbox["bbox"]["xmin"],
                                bbox["bbox"]["ymin"],
                                bbox["bbox"]["xmax"] - bbox["bbox"]["xmin"],
                                bbox["bbox"]["ymax"] - bbox["bbox"]["ymin"],
                            ],
                            "generated": bbox.get("generated"),
                            "tracker": bbox.get("tracker"),
                        }
                outs[annot["video_id"]] = {
                    "video_id": annot["video_id"],
                    "video_path": annot["video_path"],
                    "frame_count": annot["frame_count"],
                    "fps": annot["fps"],
                    "width": annot["width"],
                    "height": annot["height"],
                    "objects": tid2cat,
                    "trajectories": trajectories,
                }
        with open(os.path.join(ann_path, f"vidor_{split}.json"), "w") as f:
            json.dump(outs, f)


def preproc_vidstg(ann_path: str) -> None:
    """VidSTG {train,val,test}_annotations.json + VidOR trajectory maps ->
    {videos, trajectories} JSON with one entry per sentence, qtype tagged."""
    for fname in ("train_annotations.json", "val_annotations.json",
                  "test_annotations.json"):
        src = os.path.join(ann_path, fname)
        if not os.path.exists(src):
            continue
        with open(src) as f:
            annotations = json.load(f)
        vidor_file = (
            "vidor_training.json"
            if ("train" in fname or "val" in fname)
            else "vidor_validation.json"
        )
        with open(os.path.join(ann_path, vidor_file)) as f:
            vidor = json.load(f)
        videos, trajectories = [], {}
        for annot in annotations:
            av = vidor[annot["vid"]]
            base = {
                "original_video_id": annot["vid"],
                "frame_count": annot["frame_count"],
                "fps": annot["fps"],
                "width": annot["width"],
                "height": annot["height"],
                "start_frame": annot["used_segment"]["begin_fid"],
                "end_frame": annot["used_segment"]["end_fid"],
                "tube_start_frame": annot["temporal_gt"]["begin_fid"],
                "tube_end_frame": annot["temporal_gt"]["end_fid"],
                "video_path": av["video_path"],
            }
            for qtype, key in (("interrogative", "questions"),
                               ("declarative", "captions")):
                for query in annot[key]:
                    video = copy.deepcopy(base)
                    video["caption"] = query["description"]
                    video["type"] = query["type"]
                    video["target_id"] = query["target_id"]
                    video["video_id"] = len(videos)
                    video["qtype"] = qtype
                    videos.append(video)
                    tid = str(query["target_id"])
                    trajectories.setdefault(annot["vid"], {}).setdefault(
                        tid, av["trajectories"][tid]
                    )
        out = os.path.join(ann_path, fname.split("_")[0] + ".json")
        with open(out, "w") as f:
            json.dump({"videos": videos, "trajectories": trajectories}, f)


def preproc_hcstvg(ann_path: str, vid_path: str, v2: bool = False) -> None:
    """HC-STVG raw annotations -> flat list with video_path mapping;
    tube_end_frame = st_frame + len(bboxes) (reference preproc_hcstvg*.py)."""
    splits = ("train", "val") if v2 else ("train", "test")
    for split in splits:
        src = os.path.join(ann_path, f"{split}_raw.json")
        if not os.path.exists(src):
            continue
        with open(src) as f:
            raw = json.load(f)
        out = []
        for key, annot in raw.items():
            video_path = key
            boxes = annot["bbox"]
            st = annot["st_frame"]
            out.append(
                {
                    "video_id": len(out),
                    "video_path": video_path,
                    "frame_count": annot["img_num"],
                    "width": annot.get("img_size", [0, 0])[1]
                    if isinstance(annot.get("img_size"), list)
                    else annot.get("width", 0),
                    "height": annot.get("img_size", [0, 0])[0]
                    if isinstance(annot.get("img_size"), list)
                    else annot.get("height", 0),
                    "tube_start_frame": st,
                    "tube_end_frame": st + len(boxes),
                    "trajectory": boxes,
                    "caption": annot.get("English", annot.get("caption", "")),
                }
            )
        suffix = "_v2" if v2 else ""
        with open(os.path.join(ann_path, f"{split}{suffix}.json"), "w") as f:
            json.dump(out, f)


def main(argv=None):
    p = argparse.ArgumentParser("annotation preprocessing")
    p.add_argument("dataset", choices=["vidstg", "vidor", "hcstvg"])
    p.add_argument("--ann_path", required=True)
    p.add_argument("--vidor_path", default="")
    p.add_argument("--vid_path", default="")
    p.add_argument("--v2", action="store_true")
    args = p.parse_args(argv)
    if args.dataset == "vidor":
        preproc_vidor(args.vidor_path, args.ann_path)
    elif args.dataset == "vidstg":
        preproc_vidstg(args.ann_path)
    else:
        preproc_hcstvg(args.ann_path, args.vid_path, args.v2)


if __name__ == "__main__":
    main()
