"""RoBERTa text encoder (counterpart of ``tubedetr_tpu/models/roberta.py``).

Module names follow HuggingFace ``RobertaModel`` (``embeddings.*``,
``encoder.layer.N.attention.self.query`` ...), the names under which the
reference checkpoint stores its text encoder. Only ``last_hidden_state`` is
computed: no pooler. Post-LN blocks, exact (erf) GELU. Hidden and attention
dropout (0.1) act in train mode, at the JAX module's sites.

Tensor-parallel (``model_group`` set by ``parallel/tp.py``): the attention
holds ``local_heads`` whole heads (query/key/value by output rows,
``attention.output.dense`` by input columns), the FFN ``intermediate`` by
rows and ``output.dense`` by columns, and the embedding tables a slice of
the hidden dim, gathered before their LayerNorm.

``RobertaModel(cfg, dtype)`` computes in ``dtype`` with float32 parameters
(``models/layers.py``): the three embedding lookups and their sum in
``dtype``, the norms in float32.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from tubedetr_tpu_torch.core.sharding import gather_hidden
from tubedetr_tpu_torch.models.layers import (
    Dropout,
    Embedding,
    LayerNorm,
    Linear,
    attend,
    column_in,
    gelu,
    residual,
    row_out,
)


@dataclass(frozen=True)
class RobertaConfig:
    vocab_size: int = 50265
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    pad_token_id: int = 1
    ln_eps: float = 1e-5
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1


def roberta_position_ids(input_ids: torch.Tensor, pad_token_id: int) -> torch.Tensor:
    """HF ``create_position_ids_from_input_ids``: non-pad tokens get
    ``padding_idx + running count``, pad tokens get ``padding_idx``."""
    mask = (input_ids != pad_token_id).long()
    return torch.cumsum(mask, dim=1) * mask + pad_token_id


class _Dense(nn.Module):
    """A ``dense`` Linear, optionally followed by a residual ``LayerNorm``."""

    def __init__(self, d_in: int, d_out: int, ln_eps: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dense = Linear(d_in, d_out, dtype=dtype)
        if ln_eps:
            self.LayerNorm = LayerNorm(d_out, eps=ln_eps, dtype=dtype)


class RobertaEmbeddings(nn.Module):
    def __init__(self, c: RobertaConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pad_token_id = c.pad_token_id
        self.word_embeddings = Embedding(c.vocab_size, c.hidden_size, dtype)
        self.position_embeddings = Embedding(c.max_position_embeddings, c.hidden_size, dtype)
        self.token_type_embeddings = Embedding(c.type_vocab_size, c.hidden_size, dtype)
        self.LayerNorm = LayerNorm(c.hidden_size, eps=c.ln_eps, dtype=dtype)
        self.dropout = Dropout(c.hidden_dropout)
        self.model_group = None

    def forward(self, input_ids, pad_mask):
        pos_ids = roberta_position_ids(
            input_ids.masked_fill(pad_mask, self.pad_token_id), self.pad_token_id
        )
        x = residual(self.word_embeddings(input_ids) + self.position_embeddings(pos_ids),
                     self.token_type_embeddings(torch.zeros_like(input_ids)))
        x = gather_hidden(x, self.model_group)
        return self.dropout(self.LayerNorm(x))


class RobertaSelfAttention(nn.Module):
    def __init__(self, c: RobertaConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = c.num_attention_heads
        self.local_heads = c.num_attention_heads
        self.query = Linear(c.hidden_size, c.hidden_size, dtype=dtype)
        self.key = Linear(c.hidden_size, c.hidden_size, dtype=dtype)
        self.value = Linear(c.hidden_size, c.hidden_size, dtype=dtype)
        self.dropout = Dropout(c.attention_dropout) if c.attention_dropout > 0.0 else None

    def forward(self, x, key_pad_mask):
        out, _ = attend(self.query(x), self.key(x), self.value(x), self.local_heads, key_pad_mask,
                        self.dropout)
        return out


class RobertaAttention(nn.Module):
    def __init__(self, c: RobertaConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.self = RobertaSelfAttention(c, dtype)
        self.output = _Dense(c.hidden_size, c.hidden_size, c.ln_eps, dtype)
        self.dropout = Dropout(c.hidden_dropout)
        self.model_group = None

    def forward(self, x, key_pad_mask):
        g = self.model_group
        h = self.dropout(row_out(self.output.dense, self.self(column_in(x, g), key_pad_mask), g))
        return self.output.LayerNorm(residual(x, h))


class RobertaLayer(nn.Module):
    def __init__(self, c: RobertaConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.attention = RobertaAttention(c, dtype)
        self.intermediate = _Dense(c.hidden_size, c.intermediate_size, dtype=dtype)
        self.output = _Dense(c.intermediate_size, c.hidden_size, c.ln_eps, dtype)
        self.dropout = Dropout(c.hidden_dropout)
        self.model_group = None

    def forward(self, x, key_pad_mask):
        x = self.attention(x, key_pad_mask)
        g = self.model_group
        h = gelu(self.intermediate.dense(column_in(x, g)))  # exact erf GELU
        return self.output.LayerNorm(residual(x, self.dropout(row_out(self.output.dense, h, g))))


class RobertaEncoder(nn.Module):
    def __init__(self, c: RobertaConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layer = nn.ModuleList(RobertaLayer(c, dtype) for _ in range(c.num_hidden_layers))


class RobertaModel(nn.Module):
    def __init__(self, cfg: RobertaConfig = RobertaConfig(), dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embeddings = RobertaEmbeddings(cfg, dtype)
        self.encoder = RobertaEncoder(cfg, dtype)

    def forward(self, input_ids: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        """(B, L) int ids and (B, L) bool pad mask (True = pad) -> (B, L, hidden)."""
        x = self.embeddings(input_ids, pad_mask)
        for layer in self.encoder.layer:
            x = layer(x, pad_mask)
        return x
