"""VidSTG and HC-STVG datasets (counterpart of ``tubedetr_tpu/data/datasets.py``).

An item: annotation (``annotations.py``) -> decode (``decode.py``) ->
per-frame boxes -> one spatial transform for the clip (a sampled train
chain, or the eval resize; ``transforms.py``) applied on the host by the
staging library (``native.py``) -> the temporal crop and the dense window
-> ``VideoSample`` with numpy float32 frames.

The temporal augmentations are the reference's: a random crop (p=0.5)
that never cuts the annotated moment, then, where the clip is longer than
``video_max_len_train``, a random window of that length that overlaps the
moment. Every draw of an item comes from ``default_rng((seed, epoch,
idx))`` in the JAX package's order, so loader threads share no generator
and a seed gives both packages the same sample.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from tubedetr_tpu_torch.config import TubeDETRConfig
from tubedetr_tpu_torch.data.annotations import VideoAnnotation, load_hcstvg, load_vidstg
from tubedetr_tpu_torch.data.collate import VideoSample
from tubedetr_tpu_torch.data.decode import decode_video
from tubedetr_tpu_torch.data.native import resize_normalize_clip
from tubedetr_tpu_torch.data.transforms import (
    hflip_caption,
    make_eval_transform,
    normalize_boxes_cxcywh,
    prepare_boxes,
    sample_train_transform,
)


class STVGDataset:
    """Map-style dataset over ``VideoAnnotation`` entries."""

    def __init__(self, annotations: List[VideoAnnotation], vid_folder: str, cfg: TubeDETRConfig,
                 is_train: bool, tokenizer=None, seed: int = 0):
        self.annotations = annotations
        self.vid_folder = vid_folder
        self.cfg = cfg
        self.is_train = is_train
        self.tokenizer = tokenizer
        self.seed = seed
        self.epoch = 0

    def __len__(self):
        return len(self.annotations)

    def set_epoch(self, epoch: int):
        """The augmentations reseed each epoch (``DataLoader.set_epoch``)."""
        self.epoch = epoch

    def _rng(self, idx: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, self.epoch, idx))

    @staticmethod
    def _temporal_crop(rng, n: int, inter: List[int]):
        """(start, end) inclusive after the p=0.5 crop that keeps the moment."""
        if rng.random() <= 0.5:
            return 0, n - 1
        starts = [i for i in range(n) if not inter or i < inter[0]]
        new_start = int(rng.choice(starts)) if starts else 0
        ends = [i for i in range(n) if (i > inter[-1] if inter else i > new_start)]
        new_end = int(rng.choice(ends)) if ends else n - 1
        return new_start, new_end

    @staticmethod
    def _dense_window(rng, n: int, inter: List[int], vml_train: int):
        starts = ([i for i in range(n) if inter[0] - vml_train < i <= inter[-1]]
                  if inter else list(range(n)))
        new_start = int(rng.choice(starts)) if starts else 0
        return new_start, min(new_start + vml_train - 1, n - 1)

    def __getitem__(self, idx: int) -> VideoSample:
        cfg = self.cfg
        rng = self._rng(idx)
        ann = self.annotations[idx]
        frame_ids = list(ann.frame_ids)
        n = len(frame_ids)
        vid_path = os.path.join(self.vid_folder, ann.video_path) if self.vid_folder else ann.video_path
        frames = decode_video(vid_path, ann.start_seconds, ann.duration_seconds, n)
        if frames.shape[0] != n:
            # a pre-extracted full-rate clip (.npy): index the sampled frame
            # ids from the decode window's start
            sel = np.clip(np.asarray(frame_ids) - frame_ids[0], 0, frames.shape[0] - 1)
            frames = frames[sel]
        if frames.shape[0] != n:
            raise ValueError(f"{vid_path}: decoded {frames.shape[0]} frames, expected {n}")
        h, w = frames.shape[1:3]

        boxes_xyxy = np.zeros((n, 4), np.float64)
        inter = []
        for i, fid in enumerate(frame_ids):
            if fid in ann.boxes_xywh:
                boxes_xyxy[i] = prepare_boxes(np.asarray(ann.boxes_xywh[fid]), h, w)[0]
                inter.append(i)

        moment_boxes = boxes_xyxy[inter] if inter else np.zeros((0, 4))
        if self.is_train:
            ct = sample_train_transform(rng, h, w, moment_boxes, cfg.resolution, respect_boxes=True)
        else:
            ct = make_eval_transform(h, w, moment_boxes, cfg.resolution)
        out = resize_normalize_clip(frames, ct.a_h, ct.a_w, normalize=True)
        tb = np.zeros((n, 4), np.float64)
        if inter:
            tb[inter] = ct.boxes_xyxy

        lo, hi = 0, n - 1
        if self.is_train and cfg.tmp_crop:
            lo, hi = self._temporal_crop(rng, n, inter)
        frames_sel, tb, frame_ids = out[lo:hi + 1], tb[lo:hi + 1], frame_ids[lo:hi + 1]
        inter = [i - lo for i in inter if lo <= i <= hi]
        if self.is_train and len(frame_ids) > cfg.video_max_len_train:
            lo2, hi2 = self._dense_window(rng, len(frame_ids), inter, cfg.video_max_len_train)
            frames_sel, tb, frame_ids = frames_sel[lo2:hi2 + 1], tb[lo2:hi2 + 1], frame_ids[lo2:hi2 + 1]
            inter = [i - lo2 for i in inter if lo2 <= i <= hi2]

        caption = hflip_caption(ann.caption) if ct.hflip else ann.caption
        tokens = None
        if self.tokenizer is not None:
            tokens = np.asarray(self.tokenizer.encode(caption), np.int64)
        return VideoSample(
            frames=frames_sel.astype(np.float32, copy=False),
            valid_hw=(ct.out_h, ct.out_w),
            frames_id=frame_ids,
            video_id=ann.video_id,
            caption=caption,
            tokens=tokens,
            orig_size=(h, w),
            boxes_cxcywh=normalize_boxes_cxcywh(tb, ct.out_h, ct.out_w).astype(np.float32),
            inter_idx=(inter[0], inter[-1]) if inter else (-100, -100),
            qtype=ann.qtype,
        )


def build_dataset(name: str, image_set: str, cfg: TubeDETRConfig, tokenizer=None):
    """``synthetic``, ``vidstg`` or ``hcstvg``, split ``train``, ``val`` or
    ``test`` (HC-STVG v1 has a test split only, v2 a val split only)."""
    vml = cfg.video_max_len_train if image_set == "train" else cfg.video_max_len
    if name == "synthetic":
        from tubedetr_tpu_torch.data.synthetic import SyntheticDataset

        n = cfg.synthetic_train_size if image_set == "train" else cfg.synthetic_val_size
        res = cfg.synthetic_res
        return SyntheticDataset(
            n=n or (32 if image_set == "train" else 8),
            t=cfg.synthetic_t or min(vml, 8),
            h=res or 64,
            w=res or 64,
            seed=cfg.seed + (0 if image_set == "train" else 1000),
            vocab=cfg.text_vocab_size,
            text_len=min(cfg.max_text_len, 8),
        )
    if name == "vidstg":
        ann_file = None
        if image_set == "train" and cfg.video_max_len_train != 200 and cfg.sted:
            ann_file = f"train_{cfg.video_max_len_train}.json"
        anns = load_vidstg(cfg.vidstg_ann_path, image_set, fps=cfg.fps,
                           video_max_len=cfg.video_max_len, tmp_loc=cfg.tmp_loc,
                           ann_file=ann_file)
        folder = cfg.vidstg_vid_path
    elif name == "hcstvg":
        subset = image_set
        if image_set in ("val", "test"):
            subset = "val" if cfg.v2 else "test"
        anns = load_hcstvg(cfg.hcstvg_ann_path, subset, v2=cfg.v2, fps=cfg.fps,
                           video_max_len=cfg.video_max_len)
        folder = cfg.hcstvg_vid_path
    else:
        raise ValueError(f"unknown dataset {name}")
    return STVGDataset(anns, folder, cfg, is_train=(image_set == "train"), tokenizer=tokenizer,
                       seed=cfg.seed)
