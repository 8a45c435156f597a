"""Video-text encoder and space-time decoder (counterpart of ``tubedetr_tpu/models/transformer.py``).

Batch-first static shapes as in the JAX package: clips ``(B, Tc, S, D)`` with
``S = hw + L`` tokens, frames ``(B, T, ...)``; temporal replication is the
static gather ``clip = frame // stride``; time-aligned cross-attention folds
T into the batch so frame i's query attends only frame i's memory. Post-LN
blocks, ReLU FFNs, positions added to q/k only. Module names follow the
reference (``encoder.layers.N``, ``decoder.layers.N.cross_attn_image``,
norms 1/3/4 in the decoder). Dropout sits where the JAX modules apply it
(``models/layers.py:Dropout``, active only in train mode).

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

``no_tsa``: each time query attends only itself in the decoder's
self-attention, whose weights then come out ``(B, T*nq, 1)``. The time
embedding (``TimeEmbedding``) is the sine table (a buffer, regenerated,
never loaded), a learned ``(video_max_len, D)`` table with uniform [0, 1)
init (``learn_time_embed``), or zeros (``no_time_embed``). Every layer
computes in ``dtype`` with float32 parameters (``models/layers.py``).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from tubedetr_tpu_torch.core.embeddings import time_embedding_sine
from tubedetr_tpu_torch.core.masking import frame_to_clip
from tubedetr_tpu_torch.models.layers import (
    Dropout,
    FeatureResizer,
    LayerNorm,
    Linear,
    MultiHeadAttention,
    column_in,
    residual,
    row_out,
    sigmoid,
)
from tubedetr_tpu_torch.models.roberta import RobertaConfig, RobertaModel

LN_EPS = 1e-5  # torch nn.LayerNorm default, as in the reference's layers


class EncoderLayer(nn.Module):
    """Post-LN encoder layer: self-attn(q=k=x+pos, v=x) + FFN."""

    def __init__(self, d_model: int, nheads: int, dim_feedforward: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, nheads, dropout, dtype)
        self.linear1 = Linear(d_model, dim_feedforward, dtype=dtype)
        self.linear2 = Linear(dim_feedforward, d_model, dtype=dtype)
        self.norm1 = LayerNorm(d_model, LN_EPS, dtype)
        self.norm2 = LayerNorm(d_model, LN_EPS, dtype)
        self.dropout = Dropout(dropout)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.model_group = None  # tensor-parallel FFN (parallel/tp.py)

    def forward(self, x, pos, key_pad_mask):
        qk = x + pos
        attn, weights = self.self_attn(qk, qk, x, key_pad_mask)
        x = self.norm1(residual(x, self.dropout1(attn)))
        g = self.model_group
        h = row_out(self.linear2, self.dropout(F.relu(self.linear1(column_in(x, g)))), g)
        x = self.norm2(residual(x, self.dropout2(h)))
        return x, weights


class Encoder(nn.Module):
    """A stack of encoder layers; ``final_norm`` adds the LayerNorm that only
    the ``fast_mode="transformer"`` branch has."""

    def __init__(self, num_layers: int, d_model: int, nheads: int, dim_feedforward: int,
                 dropout: float = 0.0, final_norm: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(d_model, nheads, dim_feedforward, dropout, dtype)
            for _ in range(num_layers)
        )
        self.norm = LayerNorm(d_model, LN_EPS, dtype) if final_norm else None

    def forward(self, x, pos, key_pad_mask=None):
        for layer in self.layers:
            x, _ = layer(x, pos, key_pad_mask)
        return x if self.norm is None else self.norm(x)


class DecoderLayer(nn.Module):
    """Temporal self-attention (TSA) across the T time queries (with
    ``no_tsa``, each query attends only itself), then time-aligned
    cross-attention, then FFN."""

    def __init__(self, d_model: int, nheads: int, dim_feedforward: int, dropout: float = 0.0,
                 no_tsa: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.no_tsa = no_tsa
        self.self_attn = MultiHeadAttention(d_model, nheads, dropout, dtype)
        self.cross_attn_image = MultiHeadAttention(d_model, nheads, dropout, dtype)
        self.linear1 = Linear(d_model, dim_feedforward, dtype=dtype)
        self.linear2 = Linear(dim_feedforward, d_model, dtype=dtype)
        self.norm1 = LayerNorm(d_model, LN_EPS, dtype)
        self.norm3 = LayerNorm(d_model, LN_EPS, dtype)
        self.norm4 = LayerNorm(d_model, LN_EPS, dtype)
        self.dropout = Dropout(dropout)
        self.dropout1 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.dropout4 = Dropout(dropout)
        self.model_group = None  # tensor-parallel FFN (parallel/tp.py)

    def forward(self, tgt, query_pos, memory, memory_pos, memory_pad_mask, query_pad_mask):
        """tgt/query_pos (B, T*nq, D), frame-major; memory/memory_pos
        (B, T, S, D); memory_pad_mask (B, T, S); query_pad_mask (B, T*nq).
        True = pad. The TSA weights are (B, T*nq, T*nq), or (B, T*nq, 1)
        with ``no_tsa``. ``tgt=None``: the zero queries of the first layer;
        their sum with the attention output is the output itself, which
        norm1 then reads unrounded (XLA folds the zeros away)."""
        zero = tgt is None
        if zero:
            tgt = torch.zeros(query_pos.shape, dtype=self.norm1.compute_dtype,
                              device=query_pos.device)
        b, tq, d = tgt.shape
        t, s = memory.shape[1], memory.shape[2]
        nq = tq // t
        qk = tgt + query_pos
        if self.no_tsa:  # each query a sequence of one
            one = qk.reshape(b * tq, 1, d)
            sa, weights = self.self_attn(one, one, tgt.reshape(b * tq, 1, d), out_f32=zero)
            sa, weights = sa.reshape(b, tq, d), weights.reshape(b, tq, 1)
        else:
            sa, weights = self.self_attn(qk, qk, tgt, query_pad_mask, out_f32=zero)
        tgt = self.norm1(residual(tgt, self.dropout1(sa)))

        # each frame's nq queries attend only that frame's memory tokens
        q = (tgt + query_pos).reshape(b * t, nq, d)
        k = (memory + memory_pos).reshape(b * t, s, d)
        ca, cross_weights = self.cross_attn_image(
            q, k, memory.reshape(b * t, s, d), memory_pad_mask.reshape(b * t, s)
        )
        tgt = self.norm3(residual(tgt, self.dropout3(ca.reshape(b, tq, d))))
        g = self.model_group
        h = row_out(self.linear2, self.dropout(F.relu(self.linear1(column_in(tgt, g)))), g)
        tgt = self.norm4(residual(tgt, self.dropout4(h)))
        return tgt, weights, cross_weights.reshape(b, tq, s)


class Decoder(nn.Module):
    """Decoder stack; every layer's output passes through the shared final
    ``norm`` (the aux heads read them all)."""

    def __init__(self, num_layers: int, d_model: int, nheads: int, dim_feedforward: int,
                 dropout: float = 0.0, no_tsa: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layers = nn.ModuleList(
            DecoderLayer(d_model, nheads, dim_feedforward, dropout, no_tsa, dtype)
            for _ in range(num_layers)
        )
        self.norm = LayerNorm(d_model, LN_EPS, dtype)

    def forward(self, tgt, query_pos, memory, memory_pos, memory_pad_mask, query_pad_mask):
        """``tgt=None``: zero queries (``DecoderLayer``)."""
        hs, tsa_w, cross_w = [], [], []
        for layer in self.layers:
            tgt, w, cw = layer(tgt, query_pos, memory, memory_pos, memory_pad_mask, query_pad_mask)
            hs.append(self.norm(tgt))
            tsa_w.append(w)
            cross_w.append(cw)
        return torch.stack(hs), torch.stack(tsa_w), torch.stack(cross_w)


class TimeEmbedding(nn.Module):
    """The time queries' embedding, ``(T, D)`` in the compute dtype: the
    sine table (buffer ``te``, regenerated, never loaded), the learned
    ``time_embed`` table (``learned``) or zeros (``none``). The names are
    the reference's (``transformer.time_embed.te``,
    ``transformer.time_embed.time_embed.weight``)."""

    def __init__(self, kind: str, max_len: int, d_model: int, dtype: torch.dtype):
        super().__init__()
        self.kind, self.d_model, self.compute_dtype = kind, d_model, dtype
        if kind == "sine":
            self.register_buffer("te", time_embedding_sine(max_len, d_model), persistent=False)
        elif kind == "learned":
            self.time_embed = nn.Embedding(max_len, d_model)
            nn.init.uniform_(self.time_embed.weight, 0.0, 1.0)

    def forward(self, t: int, device) -> torch.Tensor:
        if self.kind == "none":
            return torch.zeros(t, self.d_model, dtype=self.compute_dtype, device=device)
        table = self.te if self.kind == "sine" else self.time_embed.weight
        return table[:t].to(self.compute_dtype)


class TubeDETRTransformer(nn.Module):
    """Text encoder + joint space-text encoder + fast branch (``fast_mode``)
    + temporal replication + space-time decoder.

    The text encoder lives here, as in the reference
    (``transformer.text_encoder.*``); ``TubeDETR`` calls it directly."""

    def __init__(self, d_model=256, nheads=8, enc_layers=6, dec_layers=6,
                 dim_feedforward=2048, dropout=0.1, video_max_len=200, stride=5, fast=True,
                 fast_mode: str = "", text_cfg: RobertaConfig = RobertaConfig(),
                 no_tsa: bool = False, learn_time_embed: bool = False,
                 no_time_embed: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.d_model = d_model
        self.stride = stride
        self.fast = fast
        self.fast_mode = fast_mode
        self.text_encoder = RobertaModel(text_cfg, dtype)
        self.resizer = FeatureResizer(text_cfg.hidden_size, d_model, dtype=dtype)
        # noslow has no space-text encoder (and no weights for one)
        self.encoder = (
            None if fast_mode == "noslow"
            else Encoder(enc_layers, d_model, nheads, dim_feedforward, dropout, dtype=dtype)
        )
        self.decoder = Decoder(dec_layers, d_model, nheads, dim_feedforward, dropout, no_tsa,
                               dtype)
        if fast:
            self.fast_encoder = (
                Encoder(1, d_model, nheads, dim_feedforward, dropout, final_norm=True,
                        dtype=dtype)
                if fast_mode == "transformer" else Linear(d_model, d_model, dtype=dtype)
            )
            if fast_mode in ("", "transformer", "pool"):
                self.fast_residual = Linear(d_model, d_model, dtype=dtype)
                nn.init.zeros_(self.fast_residual.weight)
                nn.init.zeros_(self.fast_residual.bias)
        kind = "none" if no_time_embed else "learned" if learn_time_embed else "sine"
        self.time_embed = TimeEmbedding(kind, video_max_len, d_model, dtype)

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
        time_embed = self.time_embed(t, dev)

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
                visual = slow_visual + slow_visual * sigmoid(fast_memory)
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
        hs, tsa_weights, cross_weights = self.decoder(  # zero queries
            None, query_pos, memory, memory_pos, mem_mask, query_pad
        )
        return {
            "hs": hs,  # (n_layers, B, T*nq, D), frame-major
            "tsa_weights": tsa_weights,  # (n_layers, B, T*nq, T*nq), or (..., 1) with no_tsa
            "cross_weights": cross_weights,  # (n_layers, B, T*nq, hw+L)
            "n_visual_tokens": hw,
        }
