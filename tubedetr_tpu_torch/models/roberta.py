"""RoBERTa text encoder (counterpart of ``tubedetr_tpu/models/roberta.py``).

Module names follow HuggingFace ``RobertaModel`` (``embeddings.*``,
``encoder.layer.N.attention.self.query`` ...), the names under which the
reference checkpoint stores its text encoder. Only ``last_hidden_state`` is
computed: no pooler. Post-LN blocks, exact (erf) GELU.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.nn import functional as F

from tubedetr_tpu_torch.models.layers import attend


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


def roberta_position_ids(input_ids: torch.Tensor, pad_token_id: int) -> torch.Tensor:
    """HF ``create_position_ids_from_input_ids``: non-pad tokens get
    ``padding_idx + running count``, pad tokens get ``padding_idx``."""
    mask = (input_ids != pad_token_id).long()
    return torch.cumsum(mask, dim=1) * mask + pad_token_id


class _Dense(nn.Module):
    """A ``dense`` Linear, optionally followed by a residual ``LayerNorm``."""

    def __init__(self, d_in: int, d_out: int, ln_eps: float = 0.0):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)
        if ln_eps:
            self.LayerNorm = nn.LayerNorm(d_out, eps=ln_eps)


class RobertaEmbeddings(nn.Module):
    def __init__(self, c: RobertaConfig):
        super().__init__()
        self.pad_token_id = c.pad_token_id
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings, c.hidden_size)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size, c.hidden_size)
        self.LayerNorm = nn.LayerNorm(c.hidden_size, eps=c.ln_eps)

    def forward(self, input_ids, pad_mask):
        pos_ids = roberta_position_ids(
            input_ids.masked_fill(pad_mask, self.pad_token_id), self.pad_token_id
        )
        x = (
            self.word_embeddings(input_ids)
            + self.position_embeddings(pos_ids)
            + self.token_type_embeddings(torch.zeros_like(input_ids))
        )
        return self.LayerNorm(x)


class RobertaSelfAttention(nn.Module):
    def __init__(self, c: RobertaConfig):
        super().__init__()
        self.num_heads = c.num_attention_heads
        self.query = nn.Linear(c.hidden_size, c.hidden_size)
        self.key = nn.Linear(c.hidden_size, c.hidden_size)
        self.value = nn.Linear(c.hidden_size, c.hidden_size)

    def forward(self, x, key_pad_mask):
        out, _ = attend(self.query(x), self.key(x), self.value(x), self.num_heads, key_pad_mask)
        return out


class RobertaAttention(nn.Module):
    def __init__(self, c: RobertaConfig):
        super().__init__()
        self.self = RobertaSelfAttention(c)
        self.output = _Dense(c.hidden_size, c.hidden_size, c.ln_eps)

    def forward(self, x, key_pad_mask):
        h = self.output.dense(self.self(x, key_pad_mask))
        return self.output.LayerNorm(x + h)


class RobertaLayer(nn.Module):
    def __init__(self, c: RobertaConfig):
        super().__init__()
        self.attention = RobertaAttention(c)
        self.intermediate = _Dense(c.hidden_size, c.intermediate_size)
        self.output = _Dense(c.intermediate_size, c.hidden_size, c.ln_eps)

    def forward(self, x, key_pad_mask):
        x = self.attention(x, key_pad_mask)
        h = F.gelu(self.intermediate.dense(x))  # exact erf GELU
        return self.output.LayerNorm(x + self.output.dense(h))


class RobertaEncoder(nn.Module):
    def __init__(self, c: RobertaConfig):
        super().__init__()
        self.layer = nn.ModuleList(RobertaLayer(c) for _ in range(c.num_hidden_layers))


class RobertaModel(nn.Module):
    def __init__(self, cfg: RobertaConfig = RobertaConfig()):
        super().__init__()
        self.embeddings = RobertaEmbeddings(cfg)
        self.encoder = RobertaEncoder(cfg)

    def forward(self, input_ids: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        """(B, L) int ids and (B, L) bool pad mask (True = pad) -> (B, L, hidden)."""
        x = self.embeddings(input_ids, pad_mask)
        for layer in self.encoder.layer:
            x = layer(x, pad_mask)
        return x
