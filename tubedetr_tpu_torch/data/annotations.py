"""VidSTG / HC-STVG annotations and frame-id sampling (the port's copy of ``tubedetr_tpu/data/annotations.py``).

One frame-sampling rule serves the datasets and the evaluator: both must
pick the same frame ids, or vIoU scores the wrong frames.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional


def sample_frame_ids(
    start_frame: int,
    end_frame: int,
    video_fps: float,
    fps: float,
    video_max_len: int,
) -> List[int]:
    """Integer-boundary fps subsampling, then a uniform cap at
    ``video_max_len``: walk the frames of ``[start, end)`` and keep frame
    ``i`` when ``int(prev_kept * rate) < int(i * rate)`` with
    ``rate = fps / video_fps`` (the first is always kept); when more than
    ``video_max_len`` survive, keep ``kept[(j * n) // video_max_len]``."""
    rate = fps / video_fps
    assert rate <= 1, f"cannot upsample: fps={fps} > video_fps={video_fps}"
    frame_ids = [start_frame]
    for fid in range(start_frame, end_frame):
        if int(frame_ids[-1] * rate) < int(fid * rate):
            frame_ids.append(fid)
    if len(frame_ids) > video_max_len:
        n = len(frame_ids)
        frame_ids = [frame_ids[(j * n) // video_max_len] for j in range(video_max_len)]
    return frame_ids


@dataclass
class VideoAnnotation:
    video_id: object
    frame_ids: List[int]  # frames to forward
    inter_frames: List[int]  # frame ids inside the GT tube
    tube_start_frame: int
    tube_end_frame: int  # exclusive
    boxes_xywh: Dict[int, List[float]]  # frame_id -> [x, y, w, h]
    caption: str
    qtype: str
    video_path: str
    start_seconds: float  # decode window
    duration_seconds: float
    width: int = 0
    height: int = 0
    video_fps: float = 0.0


def load_vidstg(
    ann_path: str,
    subset: str,
    fps: float = 5,
    video_max_len: int = 200,
    tmp_loc: bool = True,
    ann_file: Optional[str] = None,
) -> List[VideoAnnotation]:
    """A preprocessed VidSTG annotation file (``{videos, trajectories}``
    JSON, one entry a sentence)."""
    path = Path(ann_path) / (ann_file or f"{subset}.json")
    with open(path) as f:
        anns = json.load(f)
    out = []
    for video in anns["videos"]:
        video_fps = video["fps"]
        start_frame = video["start_frame"] if tmp_loc else video["tube_start_frame"]
        end_frame = video["end_frame"] if tmp_loc else video["tube_end_frame"]
        frame_ids = sample_frame_ids(start_frame, end_frame, video_fps, fps, video_max_len)
        trajectory = anns["trajectories"][video["original_video_id"]][str(video["target_id"])]
        boxes, inter = {}, []
        for fid in frame_ids:
            if video["tube_start_frame"] <= fid < video["tube_end_frame"]:
                boxes[fid] = trajectory[str(fid)]["bbox"]
                inter.append(fid)
        out.append(VideoAnnotation(
            video_id=video["video_id"],
            frame_ids=frame_ids,
            inter_frames=inter,
            tube_start_frame=video["tube_start_frame"],
            tube_end_frame=video["tube_end_frame"],
            boxes_xywh=boxes,
            caption=video["caption"],
            qtype=video.get("qtype", "declarative"),
            video_path=video.get("video_path", ""),
            start_seconds=video.get("start_seconds", start_frame / video_fps),
            duration_seconds=video.get("duration_seconds", (end_frame - start_frame) / video_fps),
            width=video.get("width", 0),
            height=video.get("height", 0),
            video_fps=video_fps,
        ))
    return out


def load_hcstvg(
    ann_path: str,
    subset: str,
    v2: bool = False,
    fps: float = 5,
    video_max_len: int = 200,
    ann_file: Optional[str] = None,
) -> List[VideoAnnotation]:
    """Preprocessed HC-STVG annotations: a flat list of 20 s videos (fps is
    ``frame_count / 20``), each trajectory indexed from the tube's start.
    Takes the ``{subset}[_v2].json`` names and the ``{subset}[v2]_proc.json``
    ones."""
    if ann_file:
        candidates = [ann_file]
    elif v2:
        candidates = [f"{subset}_v2.json", f"{subset}v2_proc.json"]
    else:
        candidates = [f"{subset}.json", f"{subset}_proc.json"]
    path = next(
        (Path(ann_path) / c for c in candidates if (Path(ann_path) / c).exists()),
        Path(ann_path) / candidates[0],
    )
    with open(path) as f:
        anns = json.load(f)
    out = []
    for video in anns:
        frame_count = video["frame_count"]
        video_fps = frame_count / 20.0
        # sampled over [0, frame_count - 1), as the reference dataset does
        frame_ids = sample_frame_ids(0, frame_count - 1, video_fps, fps, video_max_len)
        t0, t1 = video["tube_start_frame"], video["tube_end_frame"]
        boxes, inter = {}, []
        for fid in frame_ids:
            if t0 <= fid < t1 and 0 <= fid - t0 < len(video["trajectory"]):
                boxes[fid] = video["trajectory"][fid - t0]
                inter.append(fid)
        out.append(VideoAnnotation(
            video_id=video["video_id"],
            frame_ids=frame_ids,
            inter_frames=inter,
            tube_start_frame=t0,
            tube_end_frame=t1,
            boxes_xywh=boxes,
            caption=video["caption"],
            qtype="declarative",
            video_path=video.get("video_path", ""),
            start_seconds=0.0,
            duration_seconds=20.0,
            width=video.get("width", 0),
            height=video.get("height", 0),
            video_fps=video_fps,
        ))
    return out
