"""Video-text encoder and space-time decoder (counterpart of ``tubedetr_tpu/models/transformer.py``).

Batch-first static shapes as in the JAX package: clips ``(B, Tc, S, D)`` with
``S = hw + L`` tokens, frames ``(B, T, ...)``; temporal replication is the
static gather ``clip = frame // stride``; time-aligned cross-attention folds
T into the batch so frame i's query attends only frame i's memory. Post-LN
blocks, ReLU FFNs, positions added to q/k only. Module names follow the
reference (``encoder.layers.N``, ``decoder.layers.N.cross_attn_image``,
norms 1/3/4 in the decoder). Inference only: dropout is not applied.
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
    def __init__(self, num_layers: int, d_model: int, nheads: int, dim_feedforward: int):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(d_model, nheads, dim_feedforward) for _ in range(num_layers)
        )

    def forward(self, x, pos, key_pad_mask=None):
        for layer in self.layers:
            x, _ = layer(x, pos, key_pad_mask)
        return x


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
        """tgt/query_pos (B, T, D); memory/memory_pos (B, T, S, D);
        memory_pad_mask (B, T, S); query_pad_mask (B, T). True = pad."""
        b, t, d = tgt.shape
        s = memory.shape[2]
        qk = tgt + query_pos
        sa, weights = self.self_attn(qk, qk, tgt, query_pad_mask)
        tgt = self.norm1(tgt + sa)

        q = (tgt + query_pos).reshape(b * t, 1, d)
        k = (memory + memory_pos).reshape(b * t, s, d)
        ca, cross_weights = self.cross_attn_image(
            q, k, memory.reshape(b * t, s, d), memory_pad_mask.reshape(b * t, s)
        )
        tgt = self.norm3(tgt + ca.reshape(b, t, d))
        tgt = self.norm4(tgt + self.linear2(F.relu(self.linear1(tgt))))
        return tgt, weights, cross_weights.reshape(b, t, s)


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
    """Text encoder + joint space-text encoder + fast branch (default
    zero-init residual fusion) + temporal replication + space-time decoder.

    The text encoder lives here, as in the reference
    (``transformer.text_encoder.*``); ``TubeDETR`` calls it directly."""

    def __init__(self, d_model=256, nheads=8, enc_layers=6, dec_layers=6,
                 dim_feedforward=2048, video_max_len=200, stride=5, fast=True,
                 text_cfg: RobertaConfig = RobertaConfig()):
        super().__init__()
        self.d_model = d_model
        self.stride = stride
        self.fast = fast
        self.text_encoder = RobertaModel(text_cfg)
        self.resizer = FeatureResizer(text_cfg.hidden_size, d_model)
        self.encoder = Encoder(enc_layers, d_model, nheads, dim_feedforward)
        self.decoder = Decoder(dec_layers, d_model, nheads, dim_feedforward)
        if fast:
            self.fast_encoder = nn.Linear(d_model, d_model)
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
        (B, L, text_dim), text_pad_mask (B, L); query_embed (1, D); durations
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

        img_memory = self.encoder(
            cat.reshape(b * tc, s, d), cat_pos.reshape(b * tc, s, d), cat_mask.reshape(b * tc, s)
        ).reshape(b, tc, s, d)

        # temporal replication: clip -> its k frames
        f2c = frame_to_clip(t, self.stride, dev)
        memory = img_memory[:, f2c]  # (B, T, S, D)
        memory_pos = cat_pos[:, f2c]
        mem_mask = torch.cat([frame_pad_mask, text_pad_mask[:, None].expand(b, t, l)], dim=2)
        mem_mask[:, :, 0] = False  # avoid empty masks

        if self.fast and fast_src is not None:
            slow_visual = memory[:, :, :hw]
            mix = self.fast_residual(slow_visual + self.fast_encoder(fast_src))
            memory = torch.cat([slow_visual + mix, memory[:, :, hw:]], dim=2)

        time_embed = self.time_embed[:t].to(src.dtype)
        query_pos = (query_embed[None] + time_embed[None]).expand(b, t, d)
        query_pad = torch.arange(t, device=dev)[None] >= durations[:, None]
        query_pad[:, 0] = False  # avoid empty masks
        tgt = src.new_zeros(b, t, d)
        hs, tsa_weights, cross_weights = self.decoder(
            tgt, query_pos, memory, memory_pos, mem_mask, query_pad
        )
        return {
            "hs": hs,  # (n_layers, B, T, D)
            "tsa_weights": tsa_weights,  # (n_layers, B, T, T)
            "cross_weights": cross_weights,  # (n_layers, B, T, hw+L)
            "n_visual_tokens": hw,
        }
