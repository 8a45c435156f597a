"""Weights into the port: from the JAX package's variable trees, from a seed,
or from a reference TubeDETR ``.pth``.

``params_from_jax`` is the inverse of the JAX package's
``interop/torch_convert.py:convert_tubedetr``: it takes the ``{"params",
"buffers"}`` trees (as numpy) and returns the port's ``state_dict``, whose
names are the reference checkpoint's. Layout rules:

* Conv kernel HWIO ``(kH, kW, I, O)``  -> ``Conv2d.weight`` OIHW
* Dense kernel ``(in, out)``           -> ``Linear.weight`` ``(out, in)``
* attention ``q_proj``/``k_proj``/``v_proj`` -> packed ``in_proj_weight``/``in_proj_bias``
* the ``input_proj`` Dense ``(2048, D)`` -> a 1x1 ``Conv2d`` ``(D, 2048, 1, 1)``
* FrozenBatchNorm statistics come from the ``buffers`` collection
* ResNet stage tails in either layout: scanned (``layer{i}_rest/block``,
  stacked on axis 0) or unrolled (``layer{i}_{j}``)
* the fast branch as a linear layer (``""``, gating, pool, noslow) or as
  ``fast_mode="transformer"``'s encoder layer plus final norm
  (``fast_encoder/layer_0``, ``fast_encoder/norm``); noslow has no encoder.

``qscales_from_jax`` / ``qscales_to_flax`` move the int8 backbone's
calibrated activation maxima (the flax ``qscales`` collection, in either
layout) to and from the port's observer buffers, so calibration sidecars
interchange between the two packages.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch

from tubedetr_tpu_torch.train.checkpoint import warm_start_surgery

Tree = Dict


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _linear(tree: Tree, name: str) -> Dict[str, np.ndarray]:
    return {f"{name}.weight": _np(tree["kernel"]).T, f"{name}.bias": _np(tree["bias"])}


def _layernorm(tree: Tree, name: str) -> Dict[str, np.ndarray]:
    return {f"{name}.weight": _np(tree["scale"]), f"{name}.bias": _np(tree["bias"])}


def _conv(tree: Tree, name: str) -> Dict[str, np.ndarray]:
    return {f"{name}.weight": _np(tree["kernel"]).transpose(3, 2, 0, 1)}


def _frozen_bn(tree: Tree, name: str) -> Dict[str, np.ndarray]:
    return {
        f"{name}.{k}": _np(tree[k])
        for k in ("weight", "bias", "running_mean", "running_var")
    }


def _mha(tree: Tree, name: str) -> Dict[str, np.ndarray]:
    qkv = [tree[p] for p in ("q_proj", "k_proj", "v_proj")]
    return {
        f"{name}.in_proj_weight": np.concatenate([_np(p["kernel"]).T for p in qkv]),
        f"{name}.in_proj_bias": np.concatenate([_np(p["bias"]) for p in qkv]),
        **_linear(tree["out_proj"], f"{name}.out_proj"),
    }


def _mlp(tree: Tree, name: str) -> Dict[str, np.ndarray]:
    out = {}
    for key in sorted(tree, key=lambda k: int(k.split("_")[1])):
        out.update(_linear(tree[key], f"{name}.layers.{key.split('_')[1]}"))
    return out


def _bottleneck(p: Tree, b: Tree, name: str) -> Dict[str, np.ndarray]:
    out = {}
    for i in (1, 2, 3):
        out.update(_conv(p[f"conv{i}"], f"{name}.conv{i}"))
        out.update(_frozen_bn(b[f"bn{i}"], f"{name}.bn{i}"))
    if "downsample_conv" in p:
        out.update(_conv(p["downsample_conv"], f"{name}.downsample.0"))
        out.update(_frozen_bn(b["downsample_bn"], f"{name}.downsample.1"))
    return out


def _unstack(tree: Tree, j: int) -> Tree:
    if isinstance(tree, dict):
        return {k: _unstack(v, j) for k, v in tree.items()}
    return np.asarray(tree)[j]


def _tensors(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


def resnet_from_jax(params: Tree, buffers: Tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX ``ResNet`` params + FrozenBN buffers -> ``ResNet`` state_dict."""
    out = {**_conv(params["conv1"], f"{prefix}conv1"), **_frozen_bn(buffers["bn1"], f"{prefix}bn1")}
    for key in params:
        m = re.fullmatch(r"layer(\d+)_(\d+|rest)", key)
        if not m:
            continue
        li = m.group(1)
        if m.group(2) == "rest":  # scanned tails: blocks 1.. stacked on axis 0
            p, b = params[key]["block"], buffers[key]["block"]
            n = np.asarray(p["conv1"]["kernel"]).shape[0]
            for j in range(n):
                out.update(_bottleneck(
                    _unstack(p, j), _unstack(b, j), f"{prefix}layer{li}.{j + 1}"
                ))
        else:
            out.update(_bottleneck(
                params[key], buffers[key], f"{prefix}layer{li}.{m.group(2)}"
            ))
    return _tensors(out)


def roberta_from_jax(p: Tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX ``RobertaModel`` params -> ``RobertaModel`` state_dict."""
    out = {}
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        out[f"{prefix}embeddings.{name}.weight"] = _np(p[name]["embedding"])
    out.update(_layernorm(p["embeddings_norm"], f"{prefix}embeddings.LayerNorm"))
    i = 0
    while f"layer_{i}" in p:
        lp, base = p[f"layer_{i}"], f"{prefix}encoder.layer.{i}"
        att = lp["attention"]
        for src, dst in (("q_proj", "query"), ("k_proj", "key"), ("v_proj", "value")):
            out.update(_linear(att[src], f"{base}.attention.self.{dst}"))
        out.update(_linear(att["out_proj"], f"{base}.attention.output.dense"))
        out.update(_layernorm(lp["attention_norm"], f"{base}.attention.output.LayerNorm"))
        out.update(_linear(lp["intermediate"], f"{base}.intermediate.dense"))
        out.update(_linear(lp["output"], f"{base}.output.dense"))
        out.update(_layernorm(lp["output_norm"], f"{base}.output.LayerNorm"))
        i += 1
    return _tensors(out)


def mha_from_jax(tree: Tree) -> Dict[str, torch.Tensor]:
    """JAX ``MultiHeadAttention`` params -> ``MultiHeadAttention`` state_dict."""
    return _tensors({k.lstrip("."): v for k, v in _mha(tree, "").items()})


def _encoder_layer(lp: Tree, name: str) -> Dict[str, np.ndarray]:
    sd = _mha(lp["self_attn"], f"{name}.self_attn")
    for k in ("linear1", "linear2"):
        sd.update(_linear(lp[k], f"{name}.{k}"))
    for k in ("norm1", "norm2"):
        sd.update(_layernorm(lp[k], f"{name}.{k}"))
    return sd


def transformer_from_jax(tr: Tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX ``TubeDETRTransformer`` params -> the port's ``TubeDETRTransformer``
    state_dict, without its ``text_encoder`` (a sibling in the JAX tree)."""
    sd = {
        **_linear(tr["resizer"]["fc"], f"{prefix}resizer.fc"),
        **_layernorm(tr["resizer"]["layer_norm"], f"{prefix}resizer.layer_norm"),
    }
    enc = tr.get("encoder", {})  # fast_mode="noslow" has none
    i = 0
    while f"layer_{i}" in enc:
        sd.update(_encoder_layer(enc[f"layer_{i}"], f"{prefix}encoder.layers.{i}"))
        i += 1
    i = 0
    while f"layer_{i}" in tr["decoder"]:
        lp, name = tr["decoder"][f"layer_{i}"], f"{prefix}decoder.layers.{i}"
        for k in ("self_attn", "cross_attn_image"):
            sd.update(_mha(lp[k], f"{name}.{k}"))
        for k in ("linear1", "linear2"):
            sd.update(_linear(lp[k], f"{name}.{k}"))
        for k in ("norm1", "norm3", "norm4"):
            sd.update(_layernorm(lp[k], f"{name}.{k}"))
        i += 1
    sd.update(_layernorm(tr["decoder"]["norm"], f"{prefix}decoder.norm"))
    fast = tr.get("fast_encoder")
    if fast is not None and "layer_0" in fast:  # fast_mode="transformer"
        sd.update(_encoder_layer(fast["layer_0"], f"{prefix}fast_encoder.layers.0"))
        sd.update(_layernorm(fast["norm"], f"{prefix}fast_encoder.norm"))
    elif fast is not None:
        sd.update(_linear(fast, f"{prefix}fast_encoder"))
    if "fast_residual" in tr:
        sd.update(_linear(tr["fast_residual"], f"{prefix}fast_residual"))
    return _tensors(sd)


def _expected_layout(cfg) -> dict:
    """What ``TubeDETR(cfg)`` holds: encoder and decoder layers, the fast
    branch's form, the residual fusion, the objectness head."""
    fast_mode = cfg.fast_mode if cfg.fast else None
    return {
        "encoder layers": 0 if cfg.fast_mode == "noslow" else cfg.enc_layers,
        "decoder layers": cfg.dec_layers,
        "fast_encoder": None if fast_mode is None else
        ("layer" if fast_mode == "transformer" else "linear"),
        "fast_residual": fast_mode in ("", "transformer", "pool"),
        "objectness_embed": cfg.num_queries > 1,
    }


def _layout(sd: Dict) -> dict:
    fast = None
    if "transformer.fast_encoder.weight" in sd:
        fast = "linear"
    elif "transformer.fast_encoder.norm.weight" in sd:
        fast = "layer"
    return {
        "encoder layers": sum(k.startswith("transformer.encoder.layers.")
                              and k.endswith(".self_attn.in_proj_weight") for k in sd),
        "decoder layers": sum(k.endswith(".cross_attn_image.in_proj_weight") for k in sd),
        "fast_encoder": fast,
        "fast_residual": "transformer.fast_residual.weight" in sd,
        "objectness_embed": "objectness_embed.layers.0.weight" in sd,
    }


def params_from_jax(variables: Tree, cfg) -> Dict[str, torch.Tensor]:
    """The JAX package's ``{"params", "buffers"}`` variables -> the port's
    ``state_dict`` (float32 CPU tensors) for ``TubeDETR(cfg)``. Raises when
    the variables' layers or fast branch are not the ones ``cfg`` builds."""
    p = variables["params"]
    sd = resnet_from_jax(p["backbone"], variables["buffers"]["backbone"], "backbone.0.body.")
    sd.update(roberta_from_jax(p["text_encoder"], "transformer.text_encoder."))
    sd.update(transformer_from_jax(p["transformer"], "transformer."))
    heads = {
        "input_proj.weight": _np(p["input_proj"]["kernel"]).T[:, :, None, None],
        "input_proj.bias": _np(p["input_proj"]["bias"]),
        "query_embed.weight": _np(p["query_embed"]),
        **_mlp(p["bbox_embed"], "bbox_embed"),
    }
    if cfg.sted:
        heads.update(_mlp(p["sted_embed"], "sted_embed"))
    if "objectness_embed" in p:
        heads.update(_mlp(p["objectness_embed"], "objectness_embed"))
    sd.update(_tensors(heads))
    have, want = _layout(sd), _expected_layout(cfg)
    if have != want:
        raise ValueError(f"JAX variables hold {have}; the config wants {want}")
    return sd


BACKBONE_PREFIX = "backbone.0.body."


def _block_qscales(tree: Tree, name: str) -> Dict[str, np.ndarray]:
    return {
        f"{name}.conv2.act_max": _np(tree["conv2"]["act_max"]),
        f"{name}.conv3.act_max": _np(tree["conv3"]["act_max"]),
        f"{name}.out_max": _np(tree["out_max"]),
    }


def resnet_qscales_from_jax(tree: Tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """A JAX ``ResNet``'s ``qscales`` tree (scanned ``layer{i}_rest/block``
    leaves stacked on axis 0, or unrolled ``layer{i}_{j}``) -> the port's
    observer buffers by name (``ResNet.qscales``)."""
    out = {f"{prefix}stem_act_max": _np(tree["stem_act_max"])}
    for key, sub in tree.items():
        m = re.fullmatch(r"layer(\d+)_(\d+|rest)", key)
        if not m:
            continue
        li = m.group(1)
        if m.group(2) == "rest":
            blk = sub["block"]
            for j in range(np.asarray(blk["out_max"]).shape[0]):
                out.update(_block_qscales(_unstack(blk, j), f"{prefix}layer{li}.{j + 1}"))
        else:
            out.update(_block_qscales(sub, f"{prefix}layer{li}.{m.group(2)}"))
    return out


def qscales_from_jax(qscales: Tree) -> Dict[str, np.ndarray]:
    """The full model's ``qscales`` collection (``{"backbone": ...}``) ->
    the port's ``TubeDETR`` observer buffers by name."""
    return resnet_qscales_from_jax(qscales["backbone"], BACKBONE_PREFIX)


def resnet_qscales_to_flax(flat: Dict, scanned: bool, prefix: str = "") -> Tree:
    """Inverse of ``resnet_qscales_from_jax``: the port's observer values ->
    the JAX ``ResNet`` tree in the scanned or the unrolled layout."""
    tree: Tree = {}
    blocks: Dict[tuple, Dict[str, np.ndarray]] = {}
    for name, v in flat.items():
        if not name.startswith(prefix):
            continue
        rest = name[len(prefix):]
        if rest == "stem_act_max":
            tree["stem_act_max"] = _np(v).reshape(())
            continue
        m = re.fullmatch(r"layer(\d+)\.(\d+)\.(conv2\.act_max|conv3\.act_max|out_max)", rest)
        if not m:
            raise KeyError(f"not a ResNet observer: {name!r}")
        blocks.setdefault((int(m.group(1)), int(m.group(2))), {})[m.group(3)] = _np(v).reshape(())

    def leaf_tree(d):
        return {"conv2": {"act_max": d["conv2.act_max"]},
                "conv3": {"act_max": d["conv3.act_max"]}, "out_max": d["out_max"]}

    for li in sorted({li for li, _ in blocks}):
        n = 1 + max(j for l2, j in blocks if l2 == li)
        tree[f"layer{li}_0"] = leaf_tree(blocks[(li, 0)])
        tails = [leaf_tree(blocks[(li, j)]) for j in range(1, n)]
        if scanned and tails:
            tree[f"layer{li}_rest"] = {"block": {
                "conv2": {"act_max": np.stack([t["conv2"]["act_max"] for t in tails])},
                "conv3": {"act_max": np.stack([t["conv3"]["act_max"] for t in tails])},
                "out_max": np.stack([t["out_max"] for t in tails]),
            }}
        else:
            for j, t in enumerate(tails, start=1):
                tree[f"layer{li}_{j}"] = t
    return tree


def qscales_to_flax(flat: Dict, scanned: bool) -> Tree:
    """The port's ``TubeDETR`` observer values -> the JAX model's
    ``qscales`` collection (what a JAX sidecar holds)."""
    return {"backbone": resnet_qscales_to_flax(flat, scanned, BACKBONE_PREFIX)}


def fabricate_state_dict(model: torch.nn.Module, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Placeholder weights from a numpy seed, by the fill rules of the JAX
    package's ``apps/pipeline.py:fabricate_variables``: running variances,
    norm scales and 1-D weights are ones, running means and biases zeros,
    everything else ``N(0, 0.02^2)``. A checkpoint load replaces them."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, t in model.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "running_mean" or leaf.endswith("bias"):
            v = np.zeros(t.shape, np.float32)
        elif leaf == "running_var" or (leaf == "weight" and t.dim() == 1):
            v = np.ones(t.shape, np.float32)
        else:
            v = rng.standard_normal(t.shape, dtype=np.float32) * np.float32(0.02)
        out[name] = torch.from_numpy(v)
    return out


def load_reference_pth(model: torch.nn.Module, path: str) -> Tuple[list, list]:
    """Load a reference TubeDETR checkpoint into ``model``, non-strict: the
    EMA weights when the file has them, else ``model``, else the file as a
    bare state_dict; ``query_embed`` truncated to the model's queries and the
    regenerated sine time-embedding buffer dropped. Returns the (missing,
    unexpected) key lists; a shape mismatch raises."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if ckpt.get("model_ema") is not None:
        sd = ckpt["model_ema"]
    elif "model" in ckpt:
        sd = ckpt["model"]
    else:
        sd = ckpt
    sd = warm_start_surgery(sd, model.query_embed.weight.shape[0])
    result = model.load_state_dict(sd, strict=False)
    return list(result.missing_keys), list(result.unexpected_keys)
