"""The command-line surface of the port's apps (the port's copy of ``tubedetr_tpu/apps/cli.py``).

The reference's flag set with its names and defaults, mapped onto the port's
``TubeDETRConfig``: the same argv gives the same field values as the JAX
package's parser, ``--device`` aside (``cuda`` here). Settings the port does
not run yet are parsed and then refused by ``TubeDETRConfig.validate()``,
which names the ROADMAP item that brings each. Negative flags keep their
reference spelling (``--no_x``).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

from tubedetr_tpu_torch.config import TubeDETRConfig


def get_args_parser() -> argparse.ArgumentParser:
    d = TubeDETRConfig()
    p = argparse.ArgumentParser("TubeDETR-torch", add_help=False)

    # dataset
    p.add_argument("--dataset_config", default=None, help="JSON overlay path")
    p.add_argument("--combine_datasets", nargs="+", default=[],
                   help="datasets to train on: vidstg hcstvg")
    p.add_argument("--combine_datasets_val", nargs="+", default=[])
    p.add_argument("--v2", action="store_true", help="HC-STVG2.0 annotations")
    p.add_argument("--vidstg_ann_path", default="")
    p.add_argument("--vidstg_vid_path", default="")
    p.add_argument("--hcstvg_ann_path", default="")
    p.add_argument("--hcstvg_vid_path", default="")

    # training
    p.add_argument("--run_name", default="")
    p.add_argument("--lr", type=float, default=d.lr)
    p.add_argument("--lr_backbone", type=float, default=d.lr_backbone)
    p.add_argument("--text_encoder_lr", type=float, default=d.text_encoder_lr)
    p.add_argument("--batch_size", type=int, default=d.batch_size)
    p.add_argument("--grad_accum", type=int, default=d.grad_accum,
                   help="split each batch into this many microbatches and "
                        "accumulate gradients before the single clip + "
                        "optimizer step (training; the port's validate() "
                        "refuses it for now)")
    p.add_argument("--weight_decay", type=float, default=d.weight_decay)
    p.add_argument("--epochs", type=int, default=d.epochs)
    p.add_argument("--lr_drop", type=int, default=d.lr_drop)
    p.add_argument("--epoch_chunks", type=int, default=d.epoch_chunks,
                   help="split epochs into chunks for frequent checkpointing")
    p.add_argument("--optimizer", default=d.optimizer, choices=["adam", "sgd"])
    p.add_argument("--clip_max_norm", type=float, default=d.clip_max_norm)
    p.add_argument("--eval_skip", type=int, default=d.eval_skip)
    p.add_argument("--schedule", default=d.schedule,
                   choices=["step", "multistep", "linear_with_warmup",
                            "all_linear_with_warmup"])
    p.add_argument("--ema", action="store_true")
    p.add_argument("--ema_decay", type=float, default=d.ema_decay)
    p.add_argument("--fraction_warmup_steps", type=float,
                   default=d.fraction_warmup_steps)

    # model
    p.add_argument("--freeze_text_encoder", action="store_true")
    p.add_argument("--text_encoder_type", default=d.text_encoder_type)
    p.add_argument("--backbone", default=d.backbone)
    p.add_argument("--dilation", action="store_true", help="DC5 backbone")
    p.add_argument("--position_embedding", default=d.position_embedding)
    p.add_argument("--enc_layers", type=int, default=d.enc_layers)
    p.add_argument("--dec_layers", type=int, default=d.dec_layers)
    p.add_argument("--dim_feedforward", type=int, default=d.dim_feedforward)
    p.add_argument("--hidden_dim", type=int, default=d.hidden_dim)
    p.add_argument("--dropout", type=float, default=d.dropout)
    p.add_argument("--nheads", type=int, default=d.nheads)
    p.add_argument("--num_queries", type=int, default=d.num_queries)
    p.add_argument("--nq_select", type=str, default=d.nq_select,
                   choices=["first", "sted", "objectness"],
                   help="num_queries>1 inference: read query 0, rank "
                        "queries by sted confidence (per video), or read "
                        "the learned objectness head's per-frame winner "
                        "(experimental)")
    p.add_argument("--nq_match", type=str, default=d.nq_match,
                   choices=["frame", "video"],
                   help="num_queries>1 training: match the min-cost query "
                        "per frame (canonical) or ONE query per video "
                        "(summed cost — gives --nq_select sted a coherent "
                        "winner)")
    p.add_argument("--no_pass_pos_and_query", dest="pass_pos_and_query",
                   action="store_false")
    p.add_argument("--freeze_backbone", action="store_true")

    # losses
    p.add_argument("--no_aux_loss", dest="aux_loss", action="store_false")
    p.add_argument("--sigma", type=int, default=d.sigma)
    p.add_argument("--no_guided_attn", dest="guided_attn", action="store_false")
    p.add_argument("--no_sted", dest="sted", action="store_false")
    p.add_argument("--bbox_loss_coef", type=float, default=d.bbox_loss_coef)
    p.add_argument("--giou_loss_coef", type=float, default=d.giou_loss_coef)
    p.add_argument("--sted_loss_coef", type=float, default=d.sted_loss_coef)
    p.add_argument("--guided_attn_loss_coef", type=float,
                   default=d.guided_attn_loss_coef)
    p.add_argument("--objectness_loss_coef", type=float,
                   default=d.objectness_loss_coef,
                   help="num_queries>1 only: BCE weight for the per-"
                        "(frame, query) objectness head")

    # video
    p.add_argument("--resolution", type=int, default=d.resolution)
    p.add_argument("--video_max_len", type=int, default=d.video_max_len)
    p.add_argument("--video_max_len_train", type=int,
                   default=d.video_max_len_train)
    p.add_argument("--stride", type=int, default=d.stride)
    p.add_argument("--fps", type=int, default=d.fps)
    p.add_argument("--no_tmp_crop", dest="tmp_crop", action="store_false")

    # ablations
    p.add_argument("--no_fast", dest="fast", action="store_false")
    p.add_argument("--fast_mode", default="",
                   choices=["", "gating", "transformer", "pool", "noslow"])
    p.add_argument("--learn_time_embed", action="store_true")
    p.add_argument("--no_time_embed", action="store_true")
    p.add_argument("--no_tsa", action="store_true")
    p.add_argument("--rd_init_tsa", action="store_true")

    # run control
    p.add_argument("--test", action="store_true")
    p.add_argument("--eval", dest="evaluate_only", action="store_true")
    p.add_argument("--resume", default="")
    p.add_argument("--load", default="")
    p.add_argument("--output-dir", dest="output_dir", default="")
    p.add_argument("--device", default=d.device,
                   help="cuda (the default) or cpu")
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--num_workers", type=int, default=d.num_workers)
    p.add_argument("--world-size", dest="world_size", type=int, default=1)
    p.add_argument("--tb_dir", default="")

    # demo / serving
    p.add_argument("--caption_example", default="")
    p.add_argument("--video_example", default="")
    p.add_argument("--start_example", type=float, default=-1.0)
    p.add_argument("--end_example", type=float, default=-1.0)
    p.add_argument("--port", type=int, default=d.port)

    # static shapes, precision, quantization, serving, mesh
    p.add_argument("--max_text_len", type=int, default=d.max_text_len)
    p.add_argument("--text_vocab_size", type=int, default=d.text_vocab_size)
    p.add_argument("--text_hidden_size", type=int, default=d.text_hidden_size)
    p.add_argument("--text_layers", type=int, default=d.text_layers)
    p.add_argument("--text_heads", type=int, default=d.text_heads)
    p.add_argument("--text_ffn", type=int, default=d.text_ffn)
    p.add_argument("--compute_dtype", default=d.compute_dtype,
                   choices=["float32", "bfloat16"])
    p.add_argument("--frames_dtype", default=d.frames_dtype,
                   choices=["float32", "bfloat16"],
                   help="host batch frame dtype; bfloat16 halves the "
                        "host->device frame transfer (identical numerics "
                        "when compute_dtype=bfloat16)")
    p.add_argument("--compact_pad_masks", action="store_true",
                   default=d.compact_pad_masks,
                   help="ship per-frame valid extents instead of dense "
                        "pixel pad masks; rebuilt on device (iota compares)")
    p.add_argument("--device_prefetch", type=int, default=d.device_prefetch,
                   help=">0: copy the next N batches to the device on a "
                        "background thread (overlap transfer with compute)")
    p.add_argument("--backbone_quant", default=d.backbone_quant,
                   choices=["none", "int8", "int8_static", "int8_qat"],
                   help="int8 backbone convs: dynamic scales, static "
                        "calibrated scales (int8_static, inference), or "
                        "fake-quant QAT (int8_qat: train with it, then deploy "
                        "the checkpoint int8_static on the same scales)")
    p.add_argument("--backbone_quant_fast", default=d.backbone_quant_fast,
                   choices=["none", "int8", "int8_static"],
                   help="int8 the gradient-free fast-stream backbone pass "
                        "during TRAINING (params shared with the float "
                        "backbone; int8_static calibrates on one train batch)")
    p.add_argument("--backbone_quant_frozen", default=d.backbone_quant_frozen,
                   choices=["none", "int8", "int8_static"],
                   help="int8 the ALWAYS-FROZEN prefix (stem+layer1) of the "
                        "training slow pass (no parameter gradients there)")
    p.add_argument("--no_share_backbone_train", dest="share_backbone_train",
                   action="store_false", default=d.share_backbone_train,
                   help="disable training fast-pass feature reuse (run the "
                        "gradient-free fast backbone on ALL frames instead "
                        "of only the k-1 of every k the slow pass did not "
                        "already compute)")
    p.add_argument("--serve_max_batch", type=int, default=d.serve_max_batch,
                   help="serving: coalesce up to N concurrent requests "
                        "into one batched forward (1 = serialize)")
    p.add_argument("--serve_batch_window_ms", type=float,
                   default=d.serve_batch_window_ms,
                   help="serving: max ms a request waits for coalescing "
                        "partners before a partial batch dispatches")
    p.add_argument("--qscales_dir", default=".qscales_cache",
                   help="directory for persisted int8 calibration sidecars "
                        "('' disables persistence)")
    p.add_argument("--calibrate", action="store_true",
                   help="force fresh int8 calibration, overwriting any "
                        "cached qscales sidecar")
    p.add_argument("--unroll_quant_fast", action="store_true",
                   default=d.unroll_quant_fast,
                   help="training: unroll the int8 fast-stream backbone "
                        "pass's stacked blocks")
    p.add_argument("--log_quant_drift", action="store_true",
                   help="training int8 passes: log per-epoch activation-"
                        "range drift vs the baked step-0 scales")
    p.add_argument("--recalibrate_each_epoch", action="store_true",
                   default=d.recalibrate_each_epoch,
                   help="training int8/QAT passes: refresh the static "
                        "activation scales every epoch (one observer "
                        "forward)")
    p.add_argument("--synthetic_train_size", type=int,
                   default=d.synthetic_train_size,
                   help="synthetic dataset: n train videos (0 = 32)")
    p.add_argument("--synthetic_val_size", type=int,
                   default=d.synthetic_val_size,
                   help="synthetic dataset: n val videos (0 = 8)")
    p.add_argument("--synthetic_t", type=int, default=d.synthetic_t,
                   help="synthetic dataset: frames per video "
                        "(0 = min(video_max_len, 8))")
    p.add_argument("--synthetic_res", type=int, default=d.synthetic_res,
                   help="synthetic dataset: square frame size (0 = 64)")
    p.add_argument("--shard_optimizer_state", action="store_true",
                   default=d.shard_optimizer_state,
                   help="ZeRO-1: shard AdamW moments + EMA over the data "
                        "mesh axis instead of replicating")
    p.add_argument("--async_checkpoint", action="store_true",
                   default=d.async_checkpoint,
                   help="overlap checkpoint disk writes with training "
                        "(the snapshot stays synchronous)")
    p.add_argument("--shard_params", action="store_true",
                   default=d.shard_params,
                   help="FSDP/ZeRO-3: shard parameters (and EMA) over the "
                        "data mesh axis too; implies --shard_optimizer_state")
    p.add_argument("--mesh_data", type=int, default=d.mesh_data)
    p.add_argument("--mesh_time", type=int, default=d.mesh_time)
    p.add_argument("--mesh_model", type=int, default=d.mesh_model,
                   help="tensor-parallel axis size (Megatron-style "
                        "transformer sharding)")
    p.add_argument("--tokenizer_path", default="")
    return p


def config_from_args(argv: Optional[Sequence[str]] = None) -> TubeDETRConfig:
    parser = argparse.ArgumentParser(parents=[get_args_parser()])
    args = parser.parse_args(argv)
    kw = vars(args)
    overlay = kw.pop("dataset_config", None)
    known = {f.name for f in dataclasses.fields(TubeDETRConfig)}
    cfg = TubeDETRConfig(**{k: v for k, v in kw.items() if k in known})
    if overlay:
        cfg = cfg.apply_json_overlay(overlay)
    return cfg.validate()
