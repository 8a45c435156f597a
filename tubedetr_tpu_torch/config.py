"""Typed configuration, the port's copy of ``tubedetr_tpu/config.py``.

The field set is the JAX package's, so one keyword dict configures both
(the parity tests rely on that). Fields that choose only how the JAX
package lays its work out on the TPU, with the same result, are kept for
that interchange: ``space_to_depth_stem`` and ``unroll_quant_fast`` change
nothing here, and ``scan_backbone_blocks`` picks only the layout of a
qscales tree. ``validate()`` rejects every setting this port does not run
yet, naming the ROADMAP item that will bring each, so none passes unread
(the data, time and model axes and the sharded states run: ``parallel/``;
a world size that ``mesh_time * mesh_model`` does not divide is refused by
``parallel/mesh.py:mesh_shape``). The
int8 backbone modes ``int8`` and ``int8_static`` (with or without ``fused_bottleneck``) run on
the ResNets; every ``fast_mode``, ``num_queries > 1``, both
compute dtypes (training included), the sine (``sine``, ``v2``) and learned
(``learned``, ``v3``) position embeddings, ``no_tsa``, ``learn_time_embed``,
``no_time_embed``, the GroupNorm trunks (``resnet*-gn``) and every
``remat_policy`` run, and ``validate()`` accepts and refuses those fields
as the JAX package's does, the training fields (schedule, optimizer,
``grad_accum``) included. The quantized training passes run too:
``int8_qat`` (fake-quant with straight-through gradients),
``backbone_quant_fast`` and ``backbone_quant_frozen`` in ``int8`` and
``int8_static``, ``log_quant_drift`` and ``recalibrate_each_epoch``, and
every int8 mode on the GroupNorm trunks. The timm families run too
(``timm_efficientnet_b0..b3``, every ``timm_regnet{x,y}_{002..032}``,
``timm_convnext_{tiny,small,base}``: ``models/timm.py``), in every
``backbone_quant`` and ``backbone_quant_fast`` and both compute dtypes;
another ``timm_*`` name raises the JAX package's message, and
``backbone_quant_frozen`` on them is refused as there (they have no
always-frozen prefix). ``validate_training`` adds what the JAX package
refuses for training.
``apply_json_overlay`` is the CLI's ``--dataset_config``.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import List


@dataclass
class TubeDETRConfig:
    # ---- datasets ----------------------------------------------------------
    combine_datasets: List[str] = field(default_factory=list)
    combine_datasets_val: List[str] = field(default_factory=list)
    v2: bool = False
    vidstg_ann_path: str = ""
    vidstg_vid_path: str = ""
    hcstvg_ann_path: str = ""
    hcstvg_vid_path: str = ""

    # ---- training hyper-parameters ----------------------------------------
    run_name: str = ""
    save_dir: str = ""
    lr: float = 5e-5
    lr_backbone: float = 1e-5
    text_encoder_lr: float = 5e-5
    batch_size: int = 1
    grad_accum: int = 1
    weight_decay: float = 1e-4
    epochs: int = 10
    lr_drop: int = 10
    epoch_chunks: int = -1
    optimizer: str = "adam"
    clip_max_norm: float = 0.1
    eval_skip: int = 1
    schedule: str = "linear_with_warmup"
    ema: bool = False
    ema_decay: float = 0.9998
    fraction_warmup_steps: float = 0.01

    # ---- model -------------------------------------------------------------
    freeze_text_encoder: bool = False
    text_encoder_type: str = "roberta-base"
    backbone: str = "resnet101"
    dilation: bool = False
    position_embedding: str = "sine"
    enc_layers: int = 6
    dec_layers: int = 6
    dim_feedforward: int = 2048
    hidden_dim: int = 256
    dropout: float = 0.1
    nheads: int = 8
    num_queries: int = 1
    nq_select: str = "first"
    nq_match: str = "frame"
    pass_pos_and_query: bool = True
    freeze_backbone: bool = False

    # ---- losses ------------------------------------------------------------
    aux_loss: bool = True
    sigma: int = 1
    guided_attn: bool = True
    sted: bool = True
    bbox_loss_coef: float = 5.0
    giou_loss_coef: float = 2.0
    sted_loss_coef: float = 10.0
    guided_attn_loss_coef: float = 1.0
    objectness_loss_coef: float = 1.0

    # ---- video / temporal --------------------------------------------------
    resolution: int = 224
    video_max_len: int = 200
    video_max_len_train: int = 200
    stride: int = 5
    fps: int = 5
    tmp_crop: bool = True
    tmp_loc: bool = True

    # ---- ablations ---------------------------------------------------------
    fast: bool = True
    fast_mode: str = ""
    learn_time_embed: bool = False
    no_time_embed: bool = False
    no_tsa: bool = False
    rd_init_tsa: bool = False

    # ---- run control -------------------------------------------------------
    test: bool = False
    evaluate_only: bool = False
    resume: str = ""
    load: str = ""
    output_dir: str = ""
    device: str = "cuda"
    seed: int = 42
    num_workers: int = 3
    world_size: int = 1
    tb_dir: str = ""

    # ---- synthetic dataset shape -------------------------------------------
    synthetic_train_size: int = 0
    synthetic_val_size: int = 0
    synthetic_t: int = 0
    synthetic_res: int = 0

    # ---- demo / serving ----------------------------------------------------
    caption_example: str = ""
    video_example: str = ""
    start_example: float = -1.0
    end_example: float = -1.0
    port: int = 8080

    # ---- static shapes and precision ---------------------------------------
    max_text_len: int = 32  # static token-length bucket
    compute_dtype: str = "float32"  # float32 | bfloat16
    frames_dtype: str = "float32"
    compact_pad_masks: bool = False
    device_prefetch: int = 0
    mesh_data: int = 1
    mesh_time: int = 1
    mesh_model: int = 1
    tokenizer_path: str = ""  # dir with vocab.json + merges.txt
    text_vocab_size: int = 50265
    remat_backbone: bool = True
    remat_policy: str = "full"
    scan_backbone_blocks: bool = True
    space_to_depth_stem: bool = False
    share_backbone_inference: bool = True  # one backbone pass serves fast+slow
    share_backbone_train: bool = True
    backbone_quant: str = "none"
    fused_bottleneck: bool = False
    serve_max_batch: int = 1
    serve_batch_window_ms: float = 5.0
    qscales_dir: str = ""
    calibrate: bool = False
    unroll_quant_fast: bool = False
    log_quant_drift: bool = False
    recalibrate_each_epoch: bool = False
    async_checkpoint: bool = False
    shard_optimizer_state: bool = False
    shard_params: bool = False
    backbone_quant_frozen: str = "none"
    backbone_quant_fast: str = "none"
    # text encoder dims (roberta-base defaults; shrink for tests)
    text_hidden_size: int = 768
    text_layers: int = 12
    text_heads: int = 12
    text_ffn: int = 3072
    text_max_positions: int = 514

    def replace(self, **kw) -> "TubeDETRConfig":
        return dataclasses.replace(self, **kw)

    def apply_json_overlay(self, path: str) -> "TubeDETRConfig":
        """Every key of a JSON dataset config overwrites this config's value
        (``eval`` names ``evaluate_only``); an unknown key raises."""
        with open(path) as f:
            overlay = json.load(f)
        known = {f.name for f in dataclasses.fields(self)}
        clean = {}
        for k, v in overlay.items():
            k = {"eval": "evaluate_only"}.get(k, k)
            if k not in known:
                raise ValueError(f"Unknown config key {k!r} in {path}")
            clean[k] = v
        return self.replace(**clean)

    def validate(self) -> "TubeDETRConfig":
        if self.schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {self.schedule!r}; expected one of {SCHEDULES}")
        if self.optimizer not in ("adam", "sgd"):
            raise ValueError(f"unknown optimizer {self.optimizer!r}")
        if self.grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {self.grad_accum}")
        if self.batch_size % self.grad_accum != 0:
            raise ValueError(
                "batch_size must split into equal microbatches: batch_size="
                f"{self.batch_size} % grad_accum={self.grad_accum} != 0"
            )
        if self.fast_mode not in ("", "gating", "transformer", "pool", "noslow"):
            raise ValueError(f"unknown fast_mode {self.fast_mode!r}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")
        if self.frames_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown frames_dtype {self.frames_dtype!r}")
        if self.hidden_dim % self.nheads != 0:
            raise ValueError("hidden_dim must be a multiple of nheads")
        if self.num_queries < 1:
            raise ValueError(f"num_queries must be >= 1, got {self.num_queries}")
        if self.num_queries > 1 and self.no_tsa:
            # the per-frame aggregation of the TSA weights needs real TSA
            raise ValueError("num_queries > 1 requires temporal self-attention "
                             "(incompatible with --no_tsa)")
        if self.nq_select not in ("first", "sted", "objectness"):
            raise ValueError(f"unknown nq_select {self.nq_select!r}")
        if self.nq_match not in ("frame", "video"):
            raise ValueError(f"unknown nq_match {self.nq_match!r}")
        if self.nq_select == "sted" and not self.sted:
            raise ValueError("--nq_select sted ranks queries by the sted head's "
                             "confidence and requires --sted")
        if self.fast_mode and not self.fast:
            raise ValueError("fast_mode requires fast=True")
        if not self.pass_pos_and_query:
            raise NotImplementedError(
                "--no_pass_pos_and_query is non-functional in the reference"
            )
        if self.backbone_quant not in ("none", "int8", "int8_static", "int8_qat"):
            raise ValueError(f"unknown backbone_quant {self.backbone_quant!r}")
        if self.fused_bottleneck and self.backbone_quant not in ("int8", "int8_static"):
            raise ValueError("fused_bottleneck requires an int8 backbone_quant mode")
        for name in ("backbone_quant_fast", "backbone_quant_frozen"):
            if getattr(self, name) not in ("none", "int8", "int8_static"):
                raise ValueError(f"unknown {name} {getattr(self, name)!r}")
        if self.backbone_quant_fast != "none" and not self.fast:
            raise ValueError("backbone_quant_fast requires fast=True")
        if self.backbone_quant_frozen != "none" and self.backbone.startswith("timm_"):
            # the timm families have no always-frozen prefix (timm freezes
            # only BatchNorm, which is buffers here)
            raise NotImplementedError("backbone_quant_frozen applies to the resnet family only")
        if self.mesh_data < 1 and self.mesh_data != -1:
            raise ValueError(f"mesh_data must be >= 1 (or -1: every rank), got {self.mesh_data}")
        if self.mesh_time < 1:
            raise ValueError(f"mesh_time must be >= 1, got {self.mesh_time}")
        if self.mesh_model < 1:
            raise ValueError(f"mesh_model must be >= 1, got {self.mesh_model}")
        if self.position_embedding not in ("sine", "learned", "v2", "v3"):
            raise ValueError(f"unknown position_embedding {self.position_embedding!r}")
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(
                f"unknown remat_policy {self.remat_policy!r}; expected one of {REMAT_POLICIES}"
            )
        if self.backbone.startswith("timm_"):
            from tubedetr_tpu_torch.models.timm import timm_trunk_class

            timm_trunk_class(self.backbone)  # raises for a name of no family
        return self

    def validate_training(self) -> "TubeDETRConfig":
        """``validate()`` plus what training refuses: the post-training int8
        modes (no gradient passes ``round()``), as the JAX package's
        ``apps/train.py`` refuses them. Both compute dtypes train, with
        float32 parameters and optimizer state."""
        self.validate()
        if self.backbone_quant in ("int8", "int8_static"):
            raise NotImplementedError(
                f"backbone_quant={self.backbone_quant!r} trains nothing (zero "
                "gradients through round()); use it for evaluation and serving"
            )
        return self


SCHEDULES = ("step", "multistep", "linear_with_warmup", "all_linear_with_warmup")
REMAT_POLICIES = ("", "full", "save_mid", "save_acts")


def loss_weight_dict(cfg: TubeDETRConfig) -> dict:
    """Loss name -> coefficient, expanded for the aux decoder layers."""
    wd = {"loss_bbox": cfg.bbox_loss_coef, "loss_giou": cfg.giou_loss_coef}
    if cfg.sted:
        wd["loss_sted"] = cfg.sted_loss_coef
    if cfg.guided_attn:
        wd["loss_guided_attn"] = cfg.guided_attn_loss_coef
    if cfg.num_queries > 1:
        wd["loss_objectness"] = cfg.objectness_loss_coef
    if cfg.aux_loss:
        aux = {}
        for i in range(cfg.dec_layers - 1):
            aux.update({f"{k}_{i}": v for k, v in wd.items()})
        wd.update(aux)
    return wd
