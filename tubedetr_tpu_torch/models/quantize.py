"""PTQ calibration and qscales sidecars (counterpart of ``tubedetr_tpu/models/quantize.py``).

Calibration runs the int8_static model as its dynamic-observer twin
(``calibration_cfg``: ``backbone_quant="int8"``) for one forward and keeps
the activation maxima the observers recorded. The scales persist in a
sidecar ``.npz`` keyed by the quantization-relevant config slice plus a
weights tag; the key and the file format (the flax ``qscales`` tree,
flattened with ``/``) are the JAX package's, so a sidecar written by either
package loads in the other (``interop/from_jax.py`` maps the names).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tubedetr_tpu_torch.interop.from_jax import (
    BACKBONE_PREFIX,
    qscales_from_jax,
    qscales_to_flax,
)


def calibration_cfg(cfg):
    """The dynamic-observer twin of ``cfg``: int8 modes become "int8"
    (observe + dynamic scales). The JAX package also turns a quantized fast
    pass or frozen prefix into its observer twin; those are training options
    the port does not run yet (``TubeDETRConfig.validate``)."""
    return cfg.replace(backbone_quant="int8") if cfg.backbone_quant != "none" else cfg


def model_qscales(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """The model's observer buffers by name, as numpy f32 scalars."""
    body = model.backbone[0].body
    return {k: v.detach().float().cpu().numpy() for k, v in body.qscales(BACKBONE_PREFIX).items()}


def set_model_qscales(model: torch.nn.Module, flat: Dict) -> None:
    model.backbone[0].body.load_qscales(flat, BACKBONE_PREFIX)


@torch.inference_mode()
def calibrate_qscales(cfg, model: torch.nn.Module, inputs: Dict) -> Dict:
    """One observer forward of ``model`` on ``inputs`` -> the flax
    ``qscales`` tree (layout per ``cfg.scan_backbone_blocks``). The model's
    observer buffers keep the recorded maxima. One process: the JAX
    package's cross-process max of the maxima waits for multi-GPU serving
    (ROADMAP queue 1 'Multi-GPU')."""
    body = model.backbone[0].body
    if body.quant == "none":
        raise ValueError(
            f"backbone {cfg.backbone!r} recorded no quantization observers (no int8 path)"
        )
    with body.calibrating(calibration_cfg(cfg).backbone_quant):
        model(**inputs)
    return qscales_to_flax(model_qscales(model), cfg.scan_backbone_blocks)


# ---------------------------------------------------------------------------
# persistence: sidecar save/load + config-keyed cache (the JAX package's key)
# ---------------------------------------------------------------------------

_QUANT_CFG_FIELDS = (
    "backbone",
    "dilation",
    "backbone_quant",
    "backbone_quant_fast",
    "backbone_quant_frozen",
    "fused_bottleneck",
    "scan_backbone_blocks",
    "share_backbone_inference",
    "compute_dtype",
    "resolution",
    "video_max_len",
    "video_max_len_train",
    "stride",
    "fast",
    "fast_mode",
    "space_to_depth_stem",
)


def qscales_cache_key(cfg, weights_tag: str = "", data_tag: str = "") -> str:
    """Stable key over the quantization-relevant config slice, the weights
    identity tag and (when non-empty) the calibration data tag; byte for
    byte the JAX package's key."""
    slice_ = {f: getattr(cfg, f) for f in _QUANT_CFG_FIELDS}
    blob_dict = {"cfg": slice_, "weights": weights_tag}
    if data_tag:
        blob_dict["data"] = data_tag
    blob = json.dumps(blob_dict, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def file_weights_tag(path: str) -> str:
    """Weights identity of a checkpoint file: abspath + size + mtime."""
    if path and os.path.exists(path):
        st = os.stat(path)
        return f"{os.path.abspath(path)}:{st.st_size}:{int(st.st_mtime)}"
    return os.path.abspath(path) if path else ""


def weights_tag_for(cfg, default: str = "fabricate-seed0") -> str:
    """The checkpoint identity when one is configured, else ``default``."""
    for path in (cfg.resume, cfg.load):
        if path:
            return file_weights_tag(path)
    return default


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    out: Dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def save_qscales(path: str, qscales: Dict) -> None:
    """Write the qscales tree as a flat ``.npz`` (atomic replace)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **_flatten(qscales))
    os.replace(tmp, path)


def load_qscales(path: str) -> Dict:
    with np.load(path) as z:
        return _unflatten({k: z[k] for k in z.files})


def sidecar_path(cfg, cache_dir: str, weights_tag: str, data_tag: str = "") -> str:
    key = qscales_cache_key(cfg, weights_tag, data_tag=data_tag)
    return os.path.join(cache_dir, f"qscales-{key}.npz")


def get_or_calibrate_qscales(
    cfg,
    model: torch.nn.Module,
    inputs: Dict,
    cache_dir: str = "",
    weights_tag: Optional[str] = None,
    force: bool = False,
    data_tag: str = "",
) -> Tuple[Dict, str]:
    """The sidecar's scales when ``cache_dir`` holds one for this config and
    weights (and not ``force``), else one calibration forward, written to
    the sidecar. Returns ``(qscales tree, "cache" | "calibrated")``; the
    model's observers hold the scales either way."""
    path = ""
    if cache_dir:
        if weights_tag is None:
            weights_tag = weights_tag_for(cfg)
        path = sidecar_path(cfg, cache_dir, weights_tag, data_tag)
        if not force and os.path.exists(path):
            qscales = load_qscales(path)
            set_model_qscales(model, qscales_from_jax(qscales))
            return qscales, "cache"
    qscales = calibrate_qscales(cfg, model, inputs)
    if path:
        save_qscales(path, qscales)
    return qscales, "calibrated"
