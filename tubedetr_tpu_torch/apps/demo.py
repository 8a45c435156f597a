"""One-shot spatio-temporal grounding demo (counterpart of ``tubedetr_tpu/apps/demo.py``).

Decode the video, ground the caption, draw the predicted box on the frames
of the predicted segment and write the tube (``tube_frames.npy``, and
``tube.mp4`` when ffmpeg is there) to the output dir. Runs on the card
unless ``--device cpu``:

    python -m tubedetr_tpu_torch.apps.demo --load checkpoint.pth \
        --video_example clip.mp4 --caption_example "a man riding a horse" \
        --output-dir out/
"""

from __future__ import annotations

import sys

from tubedetr_tpu_torch.apps.cli import config_from_args
from tubedetr_tpu_torch.apps.pipeline import GroundingPipeline, draw_box

__all__ = ["draw_box", "main", "run_demo"]


def run_demo(cfg, video_path: str, caption: str, start: float = -1.0,
             end: float = -1.0, out_dir: str = "demo_out"):
    """Build a ``GroundingPipeline`` on ``cfg.device`` for this one call.
    A long-lived caller (the server) builds it once and calls ``ground``."""
    pipe = GroundingPipeline(cfg, device=cfg.device)
    return pipe.ground(video_path, caption, start, end, out_dir=out_dir)


def main(argv=None):
    cfg = config_from_args(argv)
    if not cfg.video_example or not cfg.caption_example:
        print("need --video_example and --caption_example")
        return 1
    run_demo(cfg, cfg.video_example, cfg.caption_example, cfg.start_example,
             cfg.end_example, cfg.output_dir or "demo_out")
    return 0


if __name__ == "__main__":
    sys.exit(main())
