"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. Without a
card, the default raises: the port never carries on silently on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tubedetr_tpu_torch runs on an NVIDIA GPU by default and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def configure_precision(device: torch.device) -> None:
    """Full float32 on the card: cuDNN convolutions default to TF32 (about
    three decimal digits), which would make a float32 model disagree with
    its reference; matmuls are set explicitly too."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
