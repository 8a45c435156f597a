"""Attention, MLP heads and FeatureResizer (counterpart of ``tubedetr_tpu/models/layers.py``).

Attention is plain matmul + softmax: the decoder's outputs include the
head-averaged attention weights, which a fused attention kernel does not
return. Parameters keep the reference's packed ``in_proj_weight`` layout.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

NEG_INF = -1e30


def masked_softmax(logits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Softmax that returns zeros (not NaN) for rows that are all ~NEG_INF."""
    m = torch.amax(logits, dim=dim, keepdim=True)
    unnorm = torch.exp(logits - torch.clamp(m, min=NEG_INF / 2))
    denom = torch.sum(unnorm, dim=dim, keepdim=True)
    return unnorm / torch.clamp(denom, min=1e-30)


def attend(q, k, v, num_heads: int, key_pad_mask: Optional[torch.Tensor] = None):
    """Scaled dot-product attention over projected (B, S, D) q/k/v.

    Returns the (B, Sq, D) head-concatenated values and the (B, h, Sq, Sk)
    weights. ``key_pad_mask`` (B, Sk) is True on padded keys."""
    b, sq, d = q.shape
    sk = k.shape[1]
    hd = d // num_heads
    q = q.reshape(b, sq, num_heads, hd).transpose(1, 2)
    k = k.reshape(b, sk, num_heads, hd).transpose(1, 2)
    v = v.reshape(b, sk, num_heads, hd).transpose(1, 2)
    logits = torch.matmul(q, k.transpose(-1, -2)) * (hd ** -0.5)
    if key_pad_mask is not None:
        logits = logits.masked_fill(key_pad_mask[:, None, None, :], NEG_INF)
    weights = masked_softmax(logits, dim=-1)
    out = torch.matmul(weights, v).transpose(1, 2).reshape(b, sq, d)
    return out, weights


class MultiHeadAttention(nn.Module):
    """Batch-first MHA with ``torch.nn.MultiheadAttention``'s parameter names
    (packed ``in_proj_weight``/``in_proj_bias``, ``out_proj``). Returns the
    output and the weights averaged over heads."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, query, key, value, key_pad_mask: Optional[torch.Tensor] = None):
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        out, weights = attend(
            F.linear(query, wq, bq), F.linear(key, wk, bk), F.linear(value, wv, bv),
            self.num_heads, key_pad_mask,
        )
        return self.out_proj(out), weights.mean(dim=1)


class MLP(nn.Module):
    """Box / sted head MLP: ReLU between layers (dropout is inference no-op)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1)
        outs = [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(nn.Linear(i, o) for i, o in zip(dims, outs))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class FeatureResizer(nn.Module):
    """Linear text_dim -> d_model + LayerNorm(eps 1e-12); dropout is an
    inference no-op."""

    def __init__(self, input_dim: int, output_dim: int):
        super().__init__()
        self.fc = nn.Linear(input_dim, output_dim)
        self.layer_norm = nn.LayerNorm(output_dim, eps=1e-12)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer_norm(self.fc(x))
