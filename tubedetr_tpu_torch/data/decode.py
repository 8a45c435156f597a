"""Video decode front-end (host side), the port's copy of ``tubedetr_tpu/data/decode.py``.

ffmpeg's rawvideo output is piped straight into numpy through a subprocess
(no ffmpeg-python dependency), and the module fails cleanly when the binary
is absent: ``.npy``/``.npz`` frame files are first-class inputs, so the
pipeline runs without ffmpeg.
"""

from __future__ import annotations

import os
import shutil
import subprocess

import numpy as np

FFMPEG = shutil.which("ffmpeg")
FFPROBE = shutil.which("ffprobe")


class DecodeError(RuntimeError):
    pass


def have_ffmpeg() -> bool:
    return FFMPEG is not None


def probe(video_path: str) -> dict:
    """ffprobe metadata: width/height/fps/duration."""
    if FFPROBE is None:
        raise DecodeError("ffprobe binary not available")
    out = subprocess.run(
        [
            FFPROBE,
            "-v",
            "error",
            "-select_streams",
            "v:0",
            "-show_entries",
            "stream=width,height,avg_frame_rate,duration",
            "-of",
            "csv=p=0",
            video_path,
        ],
        capture_output=True,
        check=True,
        text=True,
    ).stdout.strip()
    w, h, fr, dur = out.split(",")[:4]
    num, den = fr.split("/")
    return {
        "width": int(w),
        "height": int(h),
        "fps": float(num) / float(den),
        "duration": float(dur),
    }


def decode_video(
    video_path: str,
    start_seconds: float,
    duration_seconds: float,
    n_frames: int,
) -> np.ndarray:
    """Decode ``n_frames`` uniformly over [start, start+duration) seconds.

    Returns (n_frames, H, W, 3) uint8. Mirrors the reference's
    ``ffmpeg.input(ss, t).filter('fps', n/t)`` rawvideo pipe.

    Also accepts pre-extracted arrays: a ``.npy``/``.npz`` path is loaded
    directly (shape (T, H, W, 3) uint8), which is the ffmpeg-free test path.
    """
    if video_path.endswith((".npy", ".npz")):
        arr = np.load(video_path)
        if hasattr(arr, "files"):
            arr = arr[arr.files[0]]
        return np.asarray(arr)
    if os.path.isdir(video_path):  # directory of numbered frame images
        raise DecodeError(
            "frame-directory decode requires an image decoder; "
            "provide .npy clips or install ffmpeg"
        )
    if FFMPEG is None:
        raise DecodeError(
            f"ffmpeg binary not available; cannot decode {video_path}. "
            "Provide .npy/.npz frame arrays instead."
        )
    fps_filter = n_frames / duration_seconds
    cmd = [
        FFMPEG,
        "-ss",
        str(start_seconds),
        "-t",
        str(duration_seconds),
        "-i",
        video_path,
        "-vf",
        f"fps={fps_filter}",
        "-f",
        "rawvideo",
        "-pix_fmt",
        "rgb24",
        "-v",
        "error",
        "pipe:1",
    ]
    proc = subprocess.run(cmd, capture_output=True, check=True)
    meta = probe(video_path)
    h, w = meta["height"], meta["width"]
    frames = np.frombuffer(proc.stdout, np.uint8)
    per = h * w * 3
    count = len(frames) // per
    frames = frames[: count * per].reshape(count, h, w, 3)
    if count < n_frames:  # repeat last frame to the requested count
        pad = np.repeat(frames[-1:], n_frames - count, axis=0)
        frames = np.concatenate([frames, pad], axis=0)
    return frames[:n_frames]


def encode_video(
    frames: np.ndarray, out_path: str, fps: float = 5.0
) -> None:
    """Encode (T, H, W, 3) uint8 frames to h264 (tube rendering)."""
    if FFMPEG is None:
        raise DecodeError("ffmpeg binary not available; cannot encode video")
    t, h, w, _ = frames.shape
    subprocess.run(
        [
            FFMPEG,
            "-y",
            "-f",
            "rawvideo",
            "-pix_fmt",
            "rgb24",
            "-s",
            f"{w}x{h}",
            "-r",
            str(fps),
            "-i",
            "pipe:0",
            "-pix_fmt",
            "yuv420p",
            "-vcodec",
            "libx264",
            "-v",
            "error",
            out_path,
        ],
        input=frames.tobytes(),
        check=True,
    )
