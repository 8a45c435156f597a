"""Attention, MLP heads and FeatureResizer (counterpart of ``tubedetr_tpu/models/layers.py``).

Attention is plain matmul + softmax: the decoder's outputs include the
head-averaged attention weights, which a fused attention kernel does not
return. Parameters keep the reference's packed ``in_proj_weight`` layout.

With a ``model_group`` (set by ``parallel/tp.py``) a layer holds a slice
of its weights: ``column_in`` and ``row_out`` put Megatron's f and g
(``core/sharding.py``) around the sharded middle.

``Dropout`` is active only in train mode, at the sites where the JAX modules
apply ``nn.Dropout``. Its masks come from the ``torch.Generator`` that
``dropout_generator`` installs for the calling context (the train step's,
seeded from the seed and the step), else from PyTorch's default generator.
"""

from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from tubedetr_tpu_torch.core.sharding import from_model, to_model

NEG_INF = -1e30

_GENERATOR: ContextVar[Optional[torch.Generator]] = ContextVar("dropout_generator", default=None)


@contextmanager
def dropout_generator(generator: torch.Generator):
    """Draw every dropout mask inside from ``generator``."""
    token = _GENERATOR.set(generator)
    try:
        yield generator
    finally:
        _GENERATOR.reset(token)


class Dropout(nn.Module):
    """Inverted dropout as flax's: keep with probability ``1 - p``, scale the
    kept values by ``1 / (1 - p)``. The identity in eval mode."""

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=_GENERATOR.get(), device=x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros((), dtype=x.dtype, device=x.device))


def masked_softmax(logits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Softmax that returns zeros (not NaN) for rows that are all ~NEG_INF."""
    m = torch.amax(logits, dim=dim, keepdim=True)
    unnorm = torch.exp(logits - torch.clamp(m, min=NEG_INF / 2))
    denom = torch.sum(unnorm, dim=dim, keepdim=True)
    return unnorm / torch.clamp(denom, min=1e-30)


def attend(q, k, v, num_heads: int, key_pad_mask: Optional[torch.Tensor] = None,
           dropout: Optional[Dropout] = None):
    """Scaled dot-product attention over projected (B, S, D) q/k/v.

    Returns the (B, Sq, D) head-concatenated values and the (B, h, Sq, Sk)
    weights, after ``dropout`` when one is given (as the JAX module returns
    them). ``key_pad_mask`` (B, Sk) is True on padded keys."""
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
    if dropout is not None:
        weights = dropout(weights)
    out = torch.matmul(weights, v).transpose(1, 2).reshape(b, sq, d)
    return out, weights


def column_in(x: torch.Tensor, group) -> torch.Tensor:
    """A column-parallel layer's input (f); ``x`` itself without a group."""
    return to_model(x, group)


def row_out(linear: nn.Linear, x: torch.Tensor, group) -> torch.Tensor:
    """``linear`` applied to ``x``; with a group, ``linear`` holds a slice of
    its input columns: the ranks' partial products summed (g), the bias
    added once after the sum."""
    if group is None:
        return linear(x)
    return from_model(F.linear(x, linear.weight), group) + linear.bias


class MultiHeadAttention(nn.Module):
    """Batch-first MHA with ``torch.nn.MultiheadAttention``'s parameter names
    (packed ``in_proj_weight``/``in_proj_bias``, ``out_proj``). Returns the
    output and the weights averaged over heads; ``dropout`` acts on the
    attention weights.

    Tensor-parallel (``model_group`` set): the rank holds ``local_heads``
    whole heads, its packed rows ``[q_r; k_r; v_r]`` and the matching input
    columns of ``out_proj``; the head mean is completed over the group."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.local_heads = num_heads
        self.model_group = None
        self.dropout = Dropout(dropout) if dropout > 0.0 else None
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, query, key, value, key_pad_mask: Optional[torch.Tensor] = None):
        group = self.model_group
        if group is not None:  # f once for each distinct input
            entered = {}
            for x in (query, key, value):
                if id(x) not in entered:
                    entered[id(x)] = column_in(x, group)
            query, key, value = (entered[id(x)] for x in (query, key, value))
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        out, weights = attend(
            F.linear(query, wq, bq), F.linear(key, wk, bk), F.linear(value, wv, bv),
            self.local_heads, key_pad_mask, self.dropout,
        )
        if group is None:
            return self.out_proj(out), weights.mean(dim=1)
        return (row_out(self.out_proj, out, group),
                from_model(weights.sum(dim=1) / self.num_heads, group))


class MLP(nn.Module):
    """Box / sted head MLP: ReLU between layers; with ``dropout``, dropout
    after every layer, the output included (the sted head trains with 0.5
    on its logits, as the reference does)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int,
                 dropout: float = 0.0):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1)
        outs = [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(nn.Linear(i, o) for i, o in zip(dims, outs))
        self.dropout = Dropout(dropout) if dropout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
            if self.dropout is not None:
                x = self.dropout(x)
        return x


class FeatureResizer(nn.Module):
    """Linear text_dim -> d_model + LayerNorm(eps 1e-12) + dropout 0.1."""

    def __init__(self, input_dim: int, output_dim: int, dropout: float = 0.1):
        super().__init__()
        self.fc = nn.Linear(input_dim, output_dim)
        self.layer_norm = nn.LayerNorm(output_dim, eps=1e-12)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropout(self.layer_norm(self.fc(x)))
