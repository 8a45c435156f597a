"""Reusable grounding pipeline (counterpart of ``tubedetr_tpu/apps/pipeline.py``).

Builds the model once and serves many requests. A request runs decode on the
host, then on the device: the uint8 frames go up once, K1
(``ops/resize_normalize.py``) resizes and normalizes them straight into the
compute dtype, and the bucket padding and collation happen there too. Only
the masks and tokens are built on the host, and only the outputs come back.
``ground_many`` coalesces N requests into one forward at batch N.

An ``int8_static`` backbone calibrates its activation scales on the first
forward (one observer pass, ``models/quantize.py``) unless a sidecar for this
config and these weights is in ``cfg.qscales_dir``; a ``reload`` serves with
the scales its checkpoint carries, or recalibrates the same way.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np
import torch

from tubedetr_tpu_torch.config import TubeDETRConfig
from tubedetr_tpu_torch.data.collate import VideoSample, collate, model_inputs
from tubedetr_tpu_torch.data.decode import decode_video, encode_video, probe
from tubedetr_tpu_torch.data.transforms import bucket, make_eval_transform
from tubedetr_tpu_torch.interop.from_jax import fabricate_state_dict
from tubedetr_tpu_torch.models.postprocess import postprocess_boxes, postprocess_sted
from tubedetr_tpu_torch.models.quantize import (
    file_weights_tag,
    get_or_calibrate_qscales,
    set_model_qscales,
)
from tubedetr_tpu_torch.models.tokenizer import build_tokenizer
from tubedetr_tpu_torch.models.tubedetr import COMPUTE_DTYPES, build_model
from tubedetr_tpu_torch.ops.resize_normalize import resize_normalize
from tubedetr_tpu_torch.train.checkpoint import load_checkpoint, load_pretrained
from tubedetr_tpu_torch.utils.device import configure_precision, resolve_device


def draw_box(frame: np.ndarray, box, color=(255, 40, 40), width: int = 3):
    """In-place rectangle stroke on an (H, W, 3) uint8 frame."""
    h, w = frame.shape[:2]
    x0, y0, x1, y1 = [int(round(v)) for v in box]
    x0, x1 = max(0, min(x0, w - 1)), max(0, min(x1, w - 1))
    y0, y1 = max(0, min(y0, h - 1)), max(0, min(y1, h - 1))
    c = np.asarray(color, np.uint8)
    frame[y0 : y0 + width, x0:x1] = c
    frame[max(y1 - width, 0) : y1, x0:x1] = c
    frame[y0:y1, x0 : x0 + width] = c
    frame[y0:y1, max(x1 - width, 0) : x1] = c
    return frame


class GroundingPipeline:
    """Model + tokenizer on ``device``, built once.

    Weights come from ``cfg.load`` (a reference ``.pth``) or, without one,
    are fabricated from a seed (``state_dict`` replaces them, as in
    ``pipe.model.load_state_dict``)."""

    def __init__(self, cfg: TubeDETRConfig, device="cuda", seed: int = 0):
        self.cfg = cfg.validate()
        self.device = resolve_device(device)
        configure_precision(self.device)
        self.dtype = COMPUTE_DTYPES[cfg.compute_dtype]
        # K1 writes bf16 for a bf16 model and for every quantized backbone,
        # as the JAX pipeline does
        self.frames_dtype = (
            torch.bfloat16 if cfg.backbone_quant != "none" else self.dtype
        )
        self.model = build_model(cfg, self.device)
        self.model.load_state_dict(fabricate_state_dict(self.model, seed))
        self.model.cast_compute()
        self.tokenizer = build_tokenizer(cfg.tokenizer_path, cfg.text_vocab_size)
        # the port's seeded weights are not the JAX package's: their own tag
        self._weights_tag = f"fabricate-torch-seed{seed}"
        self._needs_calibration = cfg.backbone_quant == "int8_static"
        self.calibration_s = 0.0  # host seconds of the last calibration
        self.qscales_source = None  # "checkpoint", "cache" or "calibrated" once set
        self.forwards = 0  # batched forwards run (``forward`` calls)
        if cfg.load:
            self.reload(cfg.load)

    def reload(self, path: Optional[str] = None) -> str:
        """Swap weights in place from a ``.pth``: the port's own checkpoint
        (``train/checkpoint.py``) or a reference one, its EMA weights when it
        has them, loaded non-strictly after the warm-start surgery. A
        checkpoint that carries calibrated int8 scales (``qscales``) serves
        with them and runs no observer pass; otherwise an int8_static
        backbone recalibrates on the next forward unless a sidecar for these
        weights exists."""
        path = path or self.cfg.load
        if not path:
            raise ValueError("no checkpoint path configured or given")
        ckpt = load_checkpoint(path)
        missing, _ = load_pretrained(self.model, ckpt)
        if missing:
            print(f"[load] {len(missing)} tensors kept as they were (e.g. {missing[:5]})")
        self._weights_tag = file_weights_tag(path)
        qscales = ckpt.get("qscales")
        if self.cfg.backbone_quant == "int8_static" and qscales:
            set_model_qscales(self.model, qscales)
            self._needs_calibration, self.qscales_source = False, "checkpoint"
            print("[quant] int8 scales from the checkpoint")
        else:
            self._needs_calibration = self.cfg.backbone_quant == "int8_static"
            self.qscales_source = None
        return path

    def set_qscales(self, flat: dict) -> None:
        """Serve with these activation maxima (``models.quantize.model_qscales``
        names) instead of calibrating on the first forward."""
        set_model_qscales(self.model, flat)
        self._needs_calibration = False

    def _calibrate(self, inputs: dict) -> None:
        t0 = time.perf_counter()
        _, source = get_or_calibrate_qscales(
            self.cfg, self.model, inputs, cache_dir=self.cfg.qscales_dir,
            weights_tag=self._weights_tag, force=self.cfg.calibrate,
        )
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.calibration_s = time.perf_counter() - t0
        self._needs_calibration, self.qscales_source = False, source
        print(f"[quant] int8 scales {source}")

    # -- inference --------------------------------------------------------
    def prepare(self, video_path: str, caption: str, start: float, end: float,
                 video_id: str):
        """Decode + device preprocess for ONE request: (VideoSample, context
        for postprocessing and rendering)."""
        cfg = self.cfg
        if video_path.endswith((".npy", ".npz")):
            raw = decode_video(video_path, 0, 0, 0)[: cfg.video_max_len]
            ss = 0.0
        else:
            meta = probe(video_path)
            ss = max(start, 0.0)
            dur = (end if end > 0 else meta["duration"]) - ss
            raw = decode_video(video_path, ss, dur, int(min(cfg.fps * dur, cfg.video_max_len)))
        t, h, w = raw.shape[:3]

        ct = make_eval_transform(h, w, np.zeros((0, 4)), cfg.resolution)
        frames_u8 = torch.from_numpy(np.ascontiguousarray(raw, dtype=np.uint8)).to(self.device)
        # K1 writes the frames padded to the SIZE_BUCKET grid in one launch;
        # the pad is 0 in normalized units, as the JAX pipeline pads
        frames = resize_normalize(frames_u8, ct.out_h, ct.out_w, out_dtype=self.frames_dtype,
                                  pad_to=(bucket(ct.out_h), bucket(ct.out_w)))
        sample = VideoSample(
            frames=frames,
            valid_hw=(ct.out_h, ct.out_w),
            frames_id=list(range(t)),
            video_id=video_id,
            caption=caption,
            tokens=np.asarray(self.tokenizer.encode(caption), np.int64),
            orig_size=(h, w),
        )
        return sample, {"raw": raw, "h": h, "w": w, "t": t, "ss": ss}

    @torch.inference_mode()
    def forward(self, samples: List[VideoSample]):
        """One batched forward over prepared samples: (numpy outputs, batch).
        A ``num_queries > 1`` model's canonical outputs are query 0's, so the
        tube served is query 0's, as in the JAX pipeline."""
        cfg = self.cfg
        self.forwards += 1
        batch = collate(samples, cfg.video_max_len, cfg.stride, cfg.max_text_len,
                        with_fast=cfg.fast)
        inputs = model_inputs(batch)
        if self._needs_calibration:
            self._calibrate(inputs)
        out = self.model(**inputs)
        return {k: v.float().cpu().numpy() for k, v in out.items()}, batch

    def ground_many(
        self,
        requests,  # list of (video_path, caption, start, end)
        out_dir: str = "demo_out",
        render: bool = True,
        tags=None,  # per-request artifact suffixes ("" -> tube.mp4)
        return_exceptions: bool = False,
    ) -> list:
        """Batched serving: N requests -> ONE model forward at B=N.

        With ``return_exceptions=True`` a request that fails in its own
        decode or postprocess stage yields its exception in the result list
        while its batchmates complete; the forward runs on the survivors."""
        cfg = self.cfg
        if tags is None:
            tags = [f"-{i}" for i in range(len(requests))]
        n_req = len(requests)
        samples, ctxs, idx_map = [], [], []
        errs: list = [None] * n_req
        for i, (vp, cap, s0, e0) in enumerate(requests):
            try:
                sample, ctx = self.prepare(vp, cap, s0, e0, video_id=f"req{i}")
            except Exception as e:  # noqa: BLE001
                if not return_exceptions:
                    raise
                errs[i] = e
                continue
            samples.append(sample)
            ctxs.append(ctx)
            idx_map.append(i)
        results: list = [None] * n_req
        if samples:
            outputs, batch = self.forward(samples)
            if cfg.sted:
                steds = postprocess_sted(
                    outputs["pred_sted"],
                    [s.frames_id for s in samples],
                    [s.video_id for s in samples],
                    batch["time_mask"],
                )
            else:
                steds = [None] * len(samples)
            for j, i in enumerate(idx_map):
                try:
                    results[i] = self._postprocess_one(
                        outputs, steds[j], ctxs[j], j, tags[i], out_dir, render
                    )
                except Exception as e:  # noqa: BLE001
                    if not return_exceptions:
                        raise
                    errs[i] = e
        if return_exceptions:
            return [errs[i] if errs[i] is not None else results[i] for i in range(n_req)]
        return results

    def _postprocess_one(self, outputs, sted, ctx, j, tag, out_dir, render):
        cfg = self.cfg
        t, h, w, ss = ctx["t"], ctx["h"], ctx["w"], ctx["ss"]
        boxes_px = postprocess_boxes(outputs["pred_boxes"][j], np.array([h, w]))[:t]
        s_f, e_f = (0, t) if sted is None else (int(sted[0]), int(sted[1]))
        print(
            f"predicted segment: frames [{s_f}, {e_f}) "
            f"≈ seconds [{ss + s_f / cfg.fps:.2f}, {ss + e_f / cfg.fps:.2f})"
        )
        result = {"sted": [s_f, e_f], "boxes": boxes_px.tolist()}
        if render:
            os.makedirs(out_dir, exist_ok=True)
            rendered = ctx["raw"].copy()
            for k in range(s_f, min(e_f, t)):
                draw_box(rendered[k], boxes_px[k])
            np.save(os.path.join(out_dir, f"tube_frames{tag}.npy"), rendered)
            try:
                mp4 = os.path.join(out_dir, f"tube{tag}.mp4")
                encode_video(rendered, mp4, fps=cfg.fps)
                result["tube_video"] = mp4
            except Exception as e:  # noqa: BLE001
                print(f"(video encode unavailable: {e}; wrote tube_frames{tag}.npy)")
        return result

    def ground(self, video_path: str, caption: str, start: float = -1.0,
               end: float = -1.0, out_dir: str = "demo_out", render: bool = True) -> dict:
        """Decode -> K1 -> forward -> postprocess [-> tube render] for one request."""
        return self.ground_many(
            [(video_path, caption, start, end)], out_dir=out_dir, render=render, tags=[""]
        )[0]
