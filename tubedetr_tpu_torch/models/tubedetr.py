"""TubeDETR (counterpart of ``tubedetr_tpu/models/tubedetr.py``).

Module names follow the reference ``state_dict`` grammar: ``backbone.0.body.*``
(the ResNet trunk), ``transformer.*`` (text encoder, encoder, decoder, fast
branch), ``input_proj`` (a 1x1 conv), ``query_embed``, ``bbox_embed`` and
``sted_embed`` (and ``objectness_embed`` when ``num_queries > 1``); a
reference ``.pth`` loads as it is (``train/checkpoint.py:
load_pretrained``). Inputs are normalized NHWC frames plus masks, as
``data/collate.py`` builds them; the text is pre-tokenized to static length.

With ``num_queries > 1`` the canonical outputs (``pred_boxes``,
``pred_sted``, their ``aux_*``) read query 0; every query's boxes, sted
logits and objectness logits come under ``*_queries``. The TSA weights are
aggregated a frame, ``(B, T, T)`` (the mean over both query blocks, times
nq), and the cross weights averaged over each frame's queries.

``forward(train=True)`` takes the training semantics of the JAX model,
separately from ``self.training`` (which switches dropout): the slow pass
runs the backbone with gradients and the fast pass runs it under
``torch.no_grad()``, reusing the detached slow features for every k-th
frame with ``share_backbone_train``. ``train=False`` shares one backbone
pass between the streams (``share_backbone_inference``). The stem and
layer1 are always frozen, the whole trunk with ``freeze_backbone`` or
``lr_backbone <= 0``, and the text encoder with ``freeze_text_encoder``
(which also keeps it in eval mode and out of the graph).

Mixed precision is the JAX package's: parameters, gradients, optimizer
state and the EMA stay float32, and the model computes in
``cfg.compute_dtype``, each layer casting its input and weights at use
(``models/layers.py``); the heads' outputs are cast to float32 for the
losses. ``cast_compute`` stores the weights that are only ever used cast
(convs, dense layers, embedding tables) in that dtype for serving and
evaluation, with the same result. The position embedding is the sine one
(``sine``, ``v2``) or the learned 50x50 grid (``learned``, ``v3``:
``row_embed`` and ``col_embed``, channels ``[x | y]``, trained at ``lr``
as the JAX package's top-level parameters; the reference keeps them under
``backbone.1.``, which ``load_pretrained`` maps).

With ``time_group`` set, the ranks of that process group split the flat
frame axis of every trunk pass (slow, fast and shared) and all-gather the
features at the JAX package's anchor, ``constrain_frame_major``; the rest
runs whole on each rank.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from tubedetr_tpu_torch.config import TubeDETRConfig
from tubedetr_tpu_torch.core.embeddings import position_embedding_sine
from tubedetr_tpu_torch.core.masking import (
    clip_pad_mask,
    downsample_pad_mask,
    force_first_valid,
    time_pad_mask,
)
from tubedetr_tpu_torch.core.sharding import gather_frames, local_frames
from tubedetr_tpu_torch.models.layers import MLP, LayerNorm, dense, sigmoid
from tubedetr_tpu_torch.models.resnet import GroupNorm, ResNet
from tubedetr_tpu_torch.models.roberta import RobertaConfig
from tubedetr_tpu_torch.models.transformer import TubeDETRTransformer
from tubedetr_tpu_torch.utils.device import resolve_device

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class _Backbone(nn.Module):
    """Holds the trunk as ``body``, the reference's ``backbone.0.body`` path."""

    def __init__(self, body: ResNet):
        super().__init__()
        self.body = body


LEARNED_POSITIONS = ("learned", "v3")


class PointwiseConv(nn.Conv2d):
    """``input_proj``: the reference's 1x1 ``Conv2d`` weights, applied as a
    dense layer in ``dtype`` over channels-last (..., C) features."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype):
        super().__init__(cin, cout, kernel_size=1)
        self.compute_dtype = dtype

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return dense(feats, self.weight[:, :, 0, 0], self.bias, self.compute_dtype)


class TubeDETR(nn.Module):
    def __init__(self, cfg: TubeDETRConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_dim
        dtype = self.compute_dtype = COMPUTE_DTYPES[cfg.compute_dtype]
        self.backbone = nn.ModuleList([_Backbone(ResNet(
            cfg.backbone, cfg.dilation, quant=cfg.backbone_quant,
            fused_blocks=cfg.fused_bottleneck, remat=cfg.remat_backbone,
            remat_policy=cfg.remat_policy, dtype=dtype,
        ))])
        self.input_proj = PointwiseConv(2048, d, dtype)
        self.query_embed = nn.Embedding(cfg.num_queries, d)
        self.transformer = TubeDETRTransformer(
            d_model=d,
            nheads=cfg.nheads,
            enc_layers=cfg.enc_layers,
            dec_layers=cfg.dec_layers,
            dim_feedforward=cfg.dim_feedforward,
            dropout=cfg.dropout,
            video_max_len=cfg.video_max_len_train,
            stride=cfg.stride,
            fast=cfg.fast,
            fast_mode=cfg.fast_mode,
            no_tsa=cfg.no_tsa,
            learn_time_embed=cfg.learn_time_embed,
            no_time_embed=cfg.no_time_embed,
            dtype=dtype,
            text_cfg=RobertaConfig(
                vocab_size=cfg.text_vocab_size,
                hidden_size=cfg.text_hidden_size,
                num_hidden_layers=cfg.text_layers,
                num_attention_heads=cfg.text_heads,
                intermediate_size=cfg.text_ffn,
                max_position_embeddings=cfg.text_max_positions,
            ),
        )
        self.bbox_embed = MLP(d, d, 4, 3, dtype=dtype)
        if cfg.sted:
            self.sted_embed = MLP(d, d, 2, 2, dropout=0.5, dtype=dtype)
        if cfg.num_queries > 1:  # the per-(frame, query) objectness logit
            self.objectness_embed = MLP(d, d, 1, 2, dtype=dtype)
        if cfg.position_embedding in LEARNED_POSITIONS:  # the 50x50 grid, uniform [0, 1)
            self.row_embed = nn.Embedding(50, d // 2)
            self.col_embed = nn.Embedding(50, d // 2)
            nn.init.uniform_(self.row_embed.weight, 0.0, 1.0)
            nn.init.uniform_(self.col_embed.weight, 0.0, 1.0)
        if cfg.freeze_backbone or cfg.lr_backbone <= 0:
            self.backbone.requires_grad_(False)
        if cfg.freeze_text_encoder:
            self.transformer.text_encoder.requires_grad_(False)
        # the ``time`` process group whose ranks share the trunk's frames
        # (``parallel/train_step.py:parallelize`` sets it); None: all frames here
        self.time_group = None

    def train(self, mode: bool = True) -> "TubeDETR":
        """Dropout on or off; a frozen text encoder stays in eval mode."""
        super().train(mode)
        if self.cfg.freeze_text_encoder:
            self.transformer.text_encoder.eval()
        return self

    def cast_compute(self) -> "TubeDETR":
        """Store in the compute dtype the parameters that every forward casts
        to it at use, for serving and evaluation (no training step follows):
        the result is the same, bit for bit. The others stay float32, as they
        are used: the LayerNorm and GroupNorm affines (float32 statistics),
        ``query_embed`` (added in float32 to the time embedding), and the
        int8 trunk's conv weights, quantized from float32 as the JAX package
        quantizes its float32 kernels; FrozenBN statistics and the calibrated
        maxima are buffers and stay float32 too."""
        keep = set(map(id, self.backbone[0].body.int8_convs()))
        for m in self.modules():
            if isinstance(m, (LayerNorm, GroupNorm)) or id(m) in keep:
                continue
            for p in m.parameters(recurse=False):
                if p is not self.query_embed.weight:
                    p.data = p.data.to(self.compute_dtype)
        return self

    def backbone_feats(self, frames: torch.Tensor) -> torch.Tensor:
        """The trunk over a flat (N, H, W, 3) frame batch -> (N, h, w, 2048).
        With a ``time_group`` each of its ranks runs the trunk on its share
        of the N frames and the shares are all-gathered
        (``core/sharding.py``)."""
        frames = frames.to(self.compute_dtype)
        if self.time_group is None:
            return self.backbone[0].body(frames)
        n = frames.shape[0]
        return gather_frames(self.backbone[0].body(local_frames(frames, self.time_group)), n,
                             self.time_group)

    def encode_frames(self, frames: torch.Tensor, pad_mask: torch.Tensor):
        """Backbone + projection over a flat (N, H, W, 3) frame batch
        (``backbone_feats``, then ``project_frames``)."""
        return self.project_frames(self.backbone_feats(frames), pad_mask)

    def project_frames(self, feats: torch.Tensor, pad_mask: torch.Tensor):
        """Projection + masks over (N, h, w, 2048) trunk features.

        Returns tokens (N, h*w, D), feature pad mask (N, h*w) and the
        position embedding (N, h*w, D); ``pad_mask`` is the (N, H, W) pixel
        pad mask."""
        dt = self.compute_dtype
        n, h, w, _ = feats.shape
        d = self.cfg.hidden_dim
        fmask = downsample_pad_mask(pad_mask, h, w)
        if self.cfg.position_embedding in LEARNED_POSITIONS:  # channels [x | y]
            pos = torch.cat([self.col_embed.weight[None, :w].expand(h, w, d // 2),
                             self.row_embed.weight[:h, None].expand(h, w, d // 2)], dim=-1)
            pos = pos.to(dt)[None].expand(n, h, w, d)
        else:
            pos = position_embedding_sine(fmask, num_pos_feats=d // 2, dtype=dt)
        src = self.input_proj(feats)
        return src.reshape(n, h * w, d), fmask.reshape(n, h * w), pos.reshape(n, h * w, d)

    def forward(
        self,
        frames_slow: torch.Tensor,  # (B, Tc, H, W, 3) normalized
        slow_pad_mask: torch.Tensor,  # (B, Tc, H, W) True = pad
        tokens: torch.Tensor,  # (B, L) int
        text_pad_mask: torch.Tensor,  # (B, L) True = pad
        durations: torch.Tensor,  # (B,) int
        frames_fast: Optional[torch.Tensor] = None,  # (B, T, H, W, 3)
        fast_pad_mask: Optional[torch.Tensor] = None,  # (B, T, H, W)
        train: bool = False,
    ) -> dict:
        cfg = self.cfg
        d = cfg.hidden_dim
        k = max(cfg.stride, 1)
        b, tc = frames_slow.shape[:2]
        t = frames_fast.shape[1] if frames_fast is not None else min(tc * k, cfg.video_max_len_train)
        dev = frames_slow.device

        # At inference the slow frames ARE the stride-k subsample of the fast
        # frames (collate builds them so), so one backbone pass over the fast
        # stream serves both: slow tokens are a ::k gather of the fast tokens.
        share = (
            not train
            and cfg.share_backbone_inference
            and cfg.fast
            and frames_fast is not None
            and cfg.stride > 0
            and t >= (tc - 1) * cfg.stride + 1
        )
        fast_src = None
        if share:
            fsrc, fmask, fpos = self.encode_frames(
                frames_fast.flatten(0, 1), fast_pad_mask.flatten(0, 1)
            )
            hw = fsrc.shape[1]
            fast_src = fsrc.reshape(b, t, hw, d)
            frame_pad = fmask.reshape(b, t, hw)
            src = fast_src[:, :: cfg.stride][:, :tc]
            src_mask = frame_pad[:, :: cfg.stride][:, :tc]
            pos = fpos.reshape(b, t, hw, d)[:, :: cfg.stride][:, :tc]
        else:  # the slow pass, with gradients into the trunk
            slow_feats = self.backbone_feats(frames_slow.flatten(0, 1))
            src, src_mask, pos = self.project_frames(slow_feats, slow_pad_mask.flatten(0, 1))
            hw = src.shape[1]
            src, src_mask, pos = (
                src.reshape(b, tc, hw, d), src_mask.reshape(b, tc, hw), pos.reshape(b, tc, hw, d)
            )
            if cfg.fast and frames_fast is not None:
                with torch.no_grad():
                    feats = self._fast_feats(frames_fast, slow_feats, tc)
                fsrc, fmask, _ = self.project_frames(feats, fast_pad_mask.flatten(0, 1))
                fast_src = fsrc.reshape(b, t, hw, d)
                frame_pad = fmask.reshape(b, t, hw)
            else:  # replicate each clip's feature mask onto its frames
                frame_pad = src_mask[:, torch.arange(t, device=dev) // k]

        # temporal padding: clips past ceil(dur/k) and frames past the
        # duration are fully masked; clip position 0 always stays valid
        src_mask = force_first_valid(src_mask | clip_pad_mask(durations, tc, k)[:, :, None])
        frame_pad = frame_pad | time_pad_mask(durations, t)[:, :, None]

        if cfg.freeze_text_encoder:
            with torch.no_grad():
                text_memory = self.transformer.text_encoder(tokens, text_pad_mask)
        else:
            text_memory = self.transformer.text_encoder(tokens, text_pad_mask)
        tr = self.transformer(
            src=src,
            src_pad_mask=src_mask,
            pos_embed=pos,
            text_memory=text_memory,
            text_pad_mask=text_pad_mask,
            query_embed=self.query_embed.weight,
            durations=durations,
            frame_pad_mask=frame_pad,
            fast_src=fast_src,
        )
        hs = tr["hs"]  # (n_layers, B, T*nq, D), frame-major
        nl, nq = hs.shape[0], cfg.num_queries
        coord_q = sigmoid(self.bbox_embed(hs)).float().reshape(nl, b, t, nq, 4)
        # per frame: TSA weights mean over both query blocks (times nq), cross
        # weights mean over the frame's queries; both the identity at nq=1
        # (no_tsa, which requires nq=1, keeps its (B, T, 1) weights)
        tsa = tr["tsa_weights"].float()
        if not cfg.no_tsa:
            tsa = tsa.reshape(nl, b, t, nq, t, nq).mean(dim=(3, 5)) * nq
        ca = tr["cross_weights"].float().reshape(nl, b, t, nq, -1).mean(dim=3)
        out = {
            "pred_boxes": coord_q[-1, :, :, 0],
            "aux_pred_boxes": coord_q[:-1, :, :, 0],
            "weights": tsa[-1],
            "aux_weights": tsa[:-1],
            "ca_weights": ca[-1],
        }
        if cfg.sted:
            sted_q = self.sted_embed(hs).float().reshape(nl, b, t, nq, 2)
            out["pred_sted"] = sted_q[-1, :, :, 0]
            out["aux_pred_sted"] = sted_q[:-1, :, :, 0]
        if nq > 1:
            obj_q = self.objectness_embed(hs).float().reshape(nl, b, t, nq)
            out.update(pred_boxes_queries=coord_q[-1], aux_pred_boxes_queries=coord_q[:-1],
                       pred_obj_queries=obj_q[-1], aux_pred_obj_queries=obj_q[:-1])
            if cfg.sted:
                out.update(pred_sted_queries=sted_q[-1], aux_pred_sted_queries=sted_q[:-1])
        return out


    def _fast_feats(self, frames_fast: torch.Tensor, slow_feats: torch.Tensor, tc: int):
        """Trunk features of every fast frame, (B*T, h, w, 2048), without
        gradients. With ``share_backbone_train`` every k-th frame reuses its
        slow feature (collate builds ``slow = fast[::k]``) and the trunk runs
        on the other k-1 of every k; the frame axis is padded to ``tc*k`` so
        clips reshape evenly, and the pad frames are sliced away."""
        cfg = self.cfg
        b, t = frames_fast.shape[:2]
        k = max(cfg.stride, 1)
        if not (cfg.share_backbone_train and cfg.stride > 0 and tc == -(-t // k)):
            return self.backbone_feats(frames_fast.flatten(0, 1))
        slow = slow_feats.detach()
        if k == 1:  # the fast stream is the slow stream
            return slow
        ff = frames_fast
        if tc * k > t:
            ff = F.pad(ff, (0, 0, 0, 0, 0, 0, 0, tc * k - t))
        rest = ff.reshape((b, tc, k) + ff.shape[2:])[:, :, 1:].flatten(0, 2)
        rest = self.backbone_feats(rest)
        fh, fw, fc = rest.shape[1:]
        comb = torch.cat(
            [slow.reshape(b, tc, 1, fh, fw, fc).to(rest.dtype), rest.reshape(b, tc, k - 1, fh, fw, fc)],
            dim=2,
        )
        return comb.reshape(b, tc * k, fh, fw, fc)[:, :t].flatten(0, 1)


def build_model(cfg: TubeDETRConfig, device="cuda") -> TubeDETR:
    """The inference model on ``device`` (the card unless the caller asks
    for the CPU), with float32 parameters; it computes in
    ``cfg.compute_dtype``, and ``TubeDETR.cast_compute`` stores its
    cast-at-use weights in that dtype once they are in place."""
    return TubeDETR(cfg.validate()).eval().to(resolve_device(device))
