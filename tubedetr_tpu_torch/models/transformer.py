"""Video-text encoder and space-time decoder (counterpart of ``tubedetr_tpu/models/transformer.py``).

Batch-first static shapes as in the JAX package: clips ``(B, Tc, S, D)`` with
``S = hw + L`` tokens, frames ``(B, T, ...)``; temporal replication is the
static gather ``clip = frame // stride``; time-aligned cross-attention folds
T into the batch so frame i's query attends only frame i's memory. Post-LN
blocks, ReLU FFNs, positions added to q/k only. Module names follow the
reference (``encoder.layers.N``, ``decoder.layers.N.cross_attn_image``,
norms 1/3/4 in the decoder). Inference only: dropout is not applied.

The time queries are frame-major for any ``num_queries`` (nq): frame i's
queries sit at ``[i*nq, (i+1)*nq)`` of the ``T*nq`` query axis, and
cross-attention lets each frame's nq queries read that frame's memory.

``fast_mode`` picks how the fast branch (every frame, not only the stride-k
clips) joins the slow memory:

* ``""``: a linear ``fast_encoder``, fused by the zero-init residual
  ``fast_residual(slow + fast)``;
* ``"transformer"``: one temporal encoder layer with a final LayerNorm over
  each spatial position's T frames (``(B*hw, T, D)``, the time embedding as
  its position, no key mask), then the residual fusion;
* ``"pool"``: a masked spatial mean a frame, a linear layer, broadcast back
  over ``hw``, then the residual fusion;
* ``"gating"``: ``slow + slow * sigmoid(fast)``;
* ``"noslow"``: no space-text encoder; the fast memory replaces the visual
  tokens.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from tubedetr_tpu_torch.core.embeddings import time_embedding_sine
from tubedetr_tpu_torch.core.masking import frame_to_clip
from tubedetr_tpu_torch.models.layers import FeatureResizer, MultiHeadAttention
from tubedetr_tpu_torch.models.roberta import RobertaConfig, RobertaModel

LN_EPS = 1e-5  # torch nn.LayerNorm default, as in the reference's layers


class EncoderLayer(nn.Module):
    """Post-LN encoder layer: self-attn(q=k=x+pos, v=x) + FFN."""

    def __init__(self, d_model: int, nheads: int, dim_feedforward: int):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, nheads)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x, pos, key_pad_mask):
        qk = x + pos
        attn, weights = self.self_attn(qk, qk, x, key_pad_mask)
        x = self.norm1(x + attn)
        x = self.norm2(x + self.linear2(F.relu(self.linear1(x))))
        return x, weights


class Encoder(nn.Module):
    """A stack of encoder layers; ``final_norm`` adds the LayerNorm that only
    the ``fast_mode="transformer"`` branch has."""

    def __init__(self, num_layers: int, d_model: int, nheads: int, dim_feedforward: int,
                 final_norm: bool = False):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(d_model, nheads, dim_feedforward) for _ in range(num_layers)
        )
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS) if final_norm else None

    def forward(self, x, pos, key_pad_mask=None):
        for layer in self.layers:
            x, _ = layer(x, pos, key_pad_mask)
        return x if self.norm is None else self.norm(x)


class DecoderLayer(nn.Module):
    """Temporal self-attention (TSA) across the T time queries, then
    time-aligned cross-attention, then FFN."""

    def __init__(self, d_model: int, nheads: int, dim_feedforward: int):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, nheads)
        self.cross_attn_image = MultiHeadAttention(d_model, nheads)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm4 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, tgt, query_pos, memory, memory_pos, memory_pad_mask, query_pad_mask):
        """tgt/query_pos (B, T*nq, D), frame-major; memory/memory_pos
        (B, T, S, D); memory_pad_mask (B, T, S); query_pad_mask (B, T*nq).
        True = pad."""
        b, tq, d = tgt.shape
        t, s = memory.shape[1], memory.shape[2]
        nq = tq // t
        qk = tgt + query_pos
        sa, weights = self.self_attn(qk, qk, tgt, query_pad_mask)
        tgt = self.norm1(tgt + sa)

        # each frame's nq queries attend only that frame's memory tokens
        q = (tgt + query_pos).reshape(b * t, nq, d)
        k = (memory + memory_pos).reshape(b * t, s, d)
        ca, cross_weights = self.cross_attn_image(
            q, k, memory.reshape(b * t, s, d), memory_pad_mask.reshape(b * t, s)
        )
        tgt = self.norm3(tgt + ca.reshape(b, tq, d))
        tgt = self.norm4(tgt + self.linear2(F.relu(self.linear1(tgt))))
        return tgt, weights, cross_weights.reshape(b, tq, s)


class Decoder(nn.Module):
    """Decoder stack; every layer's output passes through the shared final
    ``norm`` (the aux heads read them all)."""

    def __init__(self, num_layers: int, d_model: int, nheads: int, dim_feedforward: int):
        super().__init__()
        self.layers = nn.ModuleList(
            DecoderLayer(d_model, nheads, dim_feedforward) for _ in range(num_layers)
        )
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, tgt, query_pos, memory, memory_pos, memory_pad_mask, query_pad_mask):
        hs, tsa_w, cross_w = [], [], []
        for layer in self.layers:
            tgt, w, cw = layer(tgt, query_pos, memory, memory_pos, memory_pad_mask, query_pad_mask)
            hs.append(self.norm(tgt))
            tsa_w.append(w)
            cross_w.append(cw)
        return torch.stack(hs), torch.stack(tsa_w), torch.stack(cross_w)


class TubeDETRTransformer(nn.Module):
    """Text encoder + joint space-text encoder + fast branch (``fast_mode``)
    + temporal replication + space-time decoder.

    The text encoder lives here, as in the reference
    (``transformer.text_encoder.*``); ``TubeDETR`` calls it directly."""

    def __init__(self, d_model=256, nheads=8, enc_layers=6, dec_layers=6,
                 dim_feedforward=2048, video_max_len=200, stride=5, fast=True,
                 fast_mode: str = "", text_cfg: RobertaConfig = RobertaConfig()):
        super().__init__()
        self.d_model = d_model
        self.stride = stride
        self.fast = fast
        self.fast_mode = fast_mode
        self.text_encoder = RobertaModel(text_cfg)
        self.resizer = FeatureResizer(text_cfg.hidden_size, d_model)
        # noslow has no space-text encoder (and no weights for one)
        self.encoder = (
            None if fast_mode == "noslow"
            else Encoder(enc_layers, d_model, nheads, dim_feedforward)
        )
        self.decoder = Decoder(dec_layers, d_model, nheads, dim_feedforward)
        if fast:
            self.fast_encoder = (
                Encoder(1, d_model, nheads, dim_feedforward, final_norm=True)
                if fast_mode == "transformer" else nn.Linear(d_model, d_model)
            )
            if fast_mode in ("", "transformer", "pool"):
                self.fast_residual = nn.Linear(d_model, d_model)
                nn.init.zeros_(self.fast_residual.weight)
                nn.init.zeros_(self.fast_residual.bias)
        # regenerated, never loaded: the reference drops it on load
        self.register_buffer(
            "time_embed", time_embedding_sine(video_max_len, d_model), persistent=False
        )

    def forward(self, src, src_pad_mask, pos_embed, text_memory, text_pad_mask,
                query_embed, durations, frame_pad_mask, fast_src=None):
        """src/pos_embed (B, Tc, hw, D), src_pad_mask (B, Tc, hw); text_memory
        (B, L, text_dim), text_pad_mask (B, L); query_embed (nq, D); durations
        (B,); frame_pad_mask (B, T, hw); fast_src (B, T, hw, D) or None."""
        b, tc, hw, d = src.shape
        t = frame_pad_mask.shape[1]
        l = text_memory.shape[1]
        dev = src.device

        text = self.resizer(text_memory)  # (B, L, D)
        cat = torch.cat([src, text[:, None].expand(b, tc, l, d)], dim=2)
        cat_mask = torch.cat([src_pad_mask, text_pad_mask[:, None].expand(b, tc, l)], dim=2)
        cat_pos = torch.cat([pos_embed, pos_embed.new_zeros(b, tc, l, d)], dim=2)
        s = hw + l

        if self.encoder is None:
            img_memory = cat
        else:
            img_memory = self.encoder(
                cat.reshape(b * tc, s, d), cat_pos.reshape(b * tc, s, d),
                cat_mask.reshape(b * tc, s),
            ).reshape(b, tc, s, d)
        time_embed = self.time_embed[:t].to(src.dtype)

        fast_memory = None
        if self.fast and fast_src is not None:
            if self.fast_mode == "transformer":  # one temporal layer a spatial position
                fs = fast_src.transpose(1, 2).reshape(b * hw, t, d)
                fm = self.fast_encoder(fs, time_embed[None].expand(b * hw, t, d))
                fast_memory = fm.reshape(b, hw, t, d).transpose(1, 2)
            elif self.fast_mode == "pool":  # masked spatial mean, linear, broadcast
                valid = (~frame_pad_mask)[..., None].to(fast_src.dtype)
                denom = valid.sum(dim=2).clamp(min=1.0)
                pooled = self.fast_encoder((fast_src * valid).sum(dim=2) / denom)
                fast_memory = pooled[:, :, None].expand(b, t, hw, d)
            else:
                fast_memory = self.fast_encoder(fast_src)

        # temporal replication: clip -> its k frames
        f2c = frame_to_clip(t, self.stride, dev)
        memory = img_memory[:, f2c]  # (B, T, S, D)
        memory_pos = cat_pos[:, f2c]
        mem_mask = torch.cat([frame_pad_mask, text_pad_mask[:, None].expand(b, t, l)], dim=2)
        mem_mask[:, :, 0] = False  # avoid empty masks

        if fast_memory is not None:
            slow_visual = memory[:, :, :hw]
            if self.fast_mode == "noslow":
                visual = fast_memory
            elif self.fast_mode == "gating":
                visual = slow_visual + slow_visual * torch.sigmoid(fast_memory)
            else:  # "", transformer, pool: zero-init residual fusion
                visual = slow_visual + self.fast_residual(slow_visual + fast_memory)
            memory = torch.cat([visual, memory[:, :, hw:]], dim=2)

        # frame-major time queries: frame i's nq queries at [i*nq, (i+1)*nq)
        nq = query_embed.shape[0]
        query_pos = (query_embed[None, None] + time_embed[None, :, None]).expand(b, t, nq, d)
        query_pos = query_pos.reshape(b, t * nq, d)
        query_pad = torch.arange(t, device=dev)[None] >= durations[:, None]
        query_pad = query_pad.repeat_interleave(nq, dim=1)
        query_pad[:, 0] = False  # avoid empty masks
        tgt = src.new_zeros(b, t * nq, d)
        hs, tsa_weights, cross_weights = self.decoder(
            tgt, query_pos, memory, memory_pos, mem_mask, query_pad
        )
        return {
            "hs": hs,  # (n_layers, B, T*nq, D), frame-major
            "tsa_weights": tsa_weights,  # (n_layers, B, T*nq, T*nq)
            "cross_weights": cross_weights,  # (n_layers, B, T*nq, hw+L)
            "n_visual_tokens": hw,
        }
