"""PTQ calibration, drift, and qscales sidecars (counterpart of ``tubedetr_tpu/models/quantize.py``).

Calibration runs the model as its dynamic-observer twin (``calibration_cfg``:
each int8 mode becomes ``"int8"``, and a quantized fast pass or frozen
prefix forces the two-pass forward that runs them) for one forward and
keeps the activation maxima the observers recorded, the maximum over the
ranks. ``make_drift_checker`` runs the same forward and reports how far the
observed maxima have moved past the baked ones; ``recalibrate`` writes
them, max-reduced first. The scales persist in a
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
from tubedetr_tpu_torch.parallel.dist import all_agree, allreduce_max, is_main_process


def calibration_cfg(cfg):
    """The dynamic-observer twin of ``cfg``: int8 modes become "int8"
    (observe + dynamic scales) and, when the fast pass or the frozen prefix
    is quantized, the two-pass forward is forced so that it runs."""
    out = cfg
    if cfg.backbone_quant != "none":
        out = out.replace(backbone_quant="int8")
    if cfg.backbone_quant_fast != "none":
        out = out.replace(backbone_quant_fast="int8", share_backbone_inference=False)
    if cfg.backbone_quant_frozen != "none":
        # the frozen-prefix observers live in the two-pass slow pathway
        out = out.replace(backbone_quant_frozen="int8", share_backbone_inference=False)
    return out


def model_qscales(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """The model's observer buffers by name, as numpy f32 scalars (copies)."""
    body = model.backbone[0].body
    return {k: v.detach().float().cpu().numpy().copy()
            for k, v in body.qscales(BACKBONE_PREFIX).items()}


def set_model_qscales(model: torch.nn.Module, flat: Dict) -> None:
    """Set the observers from ``flat`` (names as ``model_qscales`` gives
    them; the key sets must match)."""
    model.backbone[0].body.load_qscales(flat, BACKBONE_PREFIX)


@torch.inference_mode()
def observe_qscales(cfg, model: torch.nn.Module, inputs: Dict) -> Dict[str, torch.Tensor]:
    """One observer forward of ``model`` (``calibration_cfg``'s twin: the
    model's config is swapped for the call) on ``inputs``; returns the
    maxima it recorded by buffer name (host float32 tensors), this rank's
    alone, and leaves them in the observers. The forward runs every frame on each rank
    (``time_group`` off): the observer twin quantizes with dynamic scales,
    which a share of the frames would change."""
    body = model.backbone[0].body
    if not body.observers:
        raise ValueError(
            f"backbone {cfg.backbone!r} recorded no quantization observers (no int8 path)"
        )
    ccfg = calibration_cfg(cfg)
    saved = model.cfg, model.time_group
    model.cfg, model.time_group = ccfg, None
    try:
        with body.calibrating(ccfg.backbone_quant):
            model(**inputs)
    finally:
        model.cfg, model.time_group = saved
    return {k: v.detach().float().cpu().clone() for k, v in body.qscales(BACKBONE_PREFIX).items()}


def calibrate_qscales(cfg, model: torch.nn.Module, inputs: Dict) -> Dict:
    """One observer forward of ``model`` on ``inputs`` -> the flax
    ``qscales`` tree (layout per ``cfg.scan_backbone_blocks``). The model's
    observer buffers keep the recorded maxima. Across processes each rank
    observes its own batch and the maxima are the ranks' maximum
    (``allreduce_max``, the JAX package's ``allreduce_max_tree``), so every
    rank bakes the same int8 trunk."""
    return recalibrate(cfg, model, observe_qscales(cfg, model, inputs))


def recalibrate(cfg, model: torch.nn.Module, observed: Dict) -> Dict:
    """Write ``observed`` (a rank's own maxima by buffer name) into the
    observers as the maximum over the ranks, so that every rank holds the
    same scales (DDP broadcasts no buffer, and a broadcast from rank 0 would
    drop another rank's larger maximum). Returns the flax ``qscales``
    tree."""
    set_model_qscales(model, allreduce_max(dict(observed)))
    return qscales_to_flax(model_qscales(model), cfg.scan_backbone_blocks)


def make_drift_checker(cfg):
    """A drift probe for the quantized training passes: the trainable
    layers move, so scales baked at step 0 can under-cover later epochs.
    ``check(model, inputs)`` runs one observer forward and returns the
    worst observed/baked activation-max ratio over the flax tree's leaves
    (a stacked leaf by its maximum), that leaf's path, and the observed
    maxima by buffer name (this rank's, not max-reduced: ``recalibrate``
    bakes them). The baked scales are the ones the observers hold, and they
    hold them again afterwards. A ratio above 1 means that a baked scale
    now clips."""
    scanned = cfg.scan_backbone_blocks

    def check(model: torch.nn.Module, inputs: Dict):
        held = model_qscales(model)
        try:
            observed = observe_qscales(cfg, model, inputs)
        finally:
            set_model_qscales(model, held)
        flat_o = _flatten(qscales_to_flax({k: v.numpy() for k, v in observed.items()}, scanned))
        flat_b = _flatten(qscales_to_flax(held, scanned))
        worst, worst_key = 0.0, ""
        for k, o in flat_o.items():
            b = float(np.max(flat_b.get(k, np.zeros(1))))
            if b <= 0:
                continue
            r = float(np.max(o)) / b
            if r > worst:
                worst, worst_key = r, k
        return worst, worst_key, observed

    return check


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
    model's observers hold the scales either way. Across processes the
    ranks read the sidecar only if every one finds it (the calibration is a
    collective), and rank 0 alone writes it."""
    path = ""
    if cache_dir:
        if weights_tag is None:
            weights_tag = weights_tag_for(cfg)
        path = sidecar_path(cfg, cache_dir, weights_tag, data_tag)
        if not force and all_agree(os.path.exists(path)):
            qscales = load_qscales(path)
            set_model_qscales(model, qscales_from_jax(qscales))
            return qscales, "cache"
    qscales = calibrate_qscales(cfg, model, inputs)
    if path and is_main_process():
        save_qscales(path, qscales)
    return qscales, "calibrated"
