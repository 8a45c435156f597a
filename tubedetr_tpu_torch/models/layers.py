"""Attention, MLP heads and FeatureResizer (counterpart of ``tubedetr_tpu/models/layers.py``).

Attention is plain matmul + softmax: the decoder's outputs include the
head-averaged attention weights, which a fused attention kernel does not
return. Parameters keep the reference's packed ``in_proj_weight`` layout.

Mixed precision is the JAX package's (flax ``dtype=compute, param_dtype=
float32``): parameters stay float32, and each layer built with ``dtype``
casts its input and weights to it at use (``Linear``, ``Embedding``, the
attention projections); the attention logits and ``masked_softmax`` run in
that dtype; ``LayerNorm`` keeps its statistics and affine in float32 and
returns ``dtype``. With ``dtype=float32`` every cast is the identity. The
roundings follow what XLA computes for the JAX package in bfloat16, where
each op rounds its result to bfloat16 except where a float32 consumer
reads it (XLA then drops the round trip): a dense layer rounds its product
before it adds the bias; a Python scale is rounded to the dtype before it
multiplies; the softmax sums its unrounded exponentials, and the head mean
of the attention weights reads the float32 quotient; a LayerNorm reads its
input (a residual sum, a dense layer's biased output) unrounded, so the
callers hand it the float32 sum (``residual``, ``dense(..., out_f32=True)``);
the exact GELU rounds ``erfc`` of the unrounded ``-x / sqrt(2)``; and the
sigmoid is ``1 / (1 + exp(-x))``, each step rounded (``sigmoid``).

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


@contextmanager
def computing_in(module: nn.Module, dtype: Optional[torch.dtype]):
    """Inside, every layer of ``module`` computes in ``dtype`` (None: each
    in the dtype it was built with)."""
    layers = [m for m in module.modules() if hasattr(m, "compute_dtype")] if dtype else []
    saved = [m.compute_dtype for m in layers]
    for m in layers:
        m.compute_dtype = dtype
    try:
        yield module
    finally:
        for m, dt in zip(layers, saved):
            m.compute_dtype = dt


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


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``dtype``: input, weight and bias cast at
    use (a flax ``Dense`` with float32 parameters)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor, out_f32: bool = False) -> torch.Tensor:
        return dense(x, self.weight, self.bias, self.compute_dtype, out_f32)


def dense(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
          dtype: torch.dtype, out_f32: bool = False) -> torch.Tensor:
    """``x @ weight.T + bias`` in ``dtype``: the product rounded, then the
    bias added, that sum rounded too unless ``out_f32`` (then float32). In
    float32 the same as one ``F.linear``."""
    if dtype == torch.float32:
        return F.linear(x.float(), weight.float(), None if bias is None else bias.float())
    y = F.linear(x.to(dtype), weight.to(dtype))
    if bias is None:
        return y.float() if out_f32 else y
    if out_f32:
        return y.float() + bias.to(dtype).float()
    return y + bias.to(dtype)


def residual(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``x + h`` in float32, from operands in the compute dtype: the sum a
    LayerNorm reads unrounded."""
    return x.float() + h.float()


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU: ``F.gelu`` in float32; below it the JAX package's
    ``0.5 * x * erfc(-x * sqrt(1/2))``, ``erfc`` of the unrounded product
    rounded, then the product rounded."""
    if x.dtype == torch.float32:
        return F.gelu(x)
    half = torch.tensor(0.5 ** 0.5, dtype=x.dtype).item()
    return (0.5 * x) * torch.special.erfc(-x.float() * half).to(x.dtype)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` whose statistics and affine run in float32 on the
    float32 input; the result is cast to ``dtype`` (flax ``LayerNorm`` with
    ``dtype``)."""

    def __init__(self, d: int, eps: float, dtype: torch.dtype = torch.float32):
        super().__init__(d, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(self.compute_dtype)


class Embedding(nn.Embedding):
    """``nn.Embedding`` whose table is cast to ``dtype`` before the lookup
    (flax ``Embed`` with ``dtype``)."""

    def __init__(self, num: int, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__(num, dim)
        self.compute_dtype = dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight.to(self.compute_dtype))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``torch.sigmoid`` in float32; below it XLA's expansion of the
    logistic, ``1 / (1 + exp(-x))`` with each step in ``x``'s dtype."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1 / (1 + torch.exp(-x))


def masked_softmax(logits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Softmax that returns zeros (not NaN) for rows that are all ~NEG_INF;
    each step in the logits' dtype, the quotient returned in float32."""
    m = torch.amax(logits, dim=dim, keepdim=True)
    unnorm = torch.exp((logits - torch.clamp(m, min=NEG_INF / 2)).float())
    denom = torch.sum(unnorm, dim=dim, keepdim=True).to(logits.dtype)
    return unnorm.to(logits.dtype).float() / torch.clamp(denom, min=1e-30).float()


def attend(q, k, v, num_heads: int, key_pad_mask: Optional[torch.Tensor] = None,
           dropout: Optional[Dropout] = None):
    """Scaled dot-product attention over projected (B, S, D) q/k/v.

    Returns the (B, Sq, D) head-concatenated values, in q's dtype, and the
    (B, h, Sq, Sk) weights in float32, after ``dropout`` when one is given
    (as the JAX module returns them). ``key_pad_mask`` (B, Sk) is True on
    padded keys."""
    b, sq, d = q.shape
    sk = k.shape[1]
    hd = d // num_heads
    q = q.reshape(b, sq, num_heads, hd).transpose(1, 2)
    k = k.reshape(b, sk, num_heads, hd).transpose(1, 2)
    v = v.reshape(b, sk, num_heads, hd).transpose(1, 2)
    scale = torch.tensor(hd ** -0.5, dtype=q.dtype).item()  # a weak-typed scale: rounded first
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    if key_pad_mask is not None:
        logits = logits.masked_fill(key_pad_mask[:, None, None, :], NEG_INF)
    weights = masked_softmax(logits, dim=-1)
    if dropout is not None and dropout.training:  # on the weights in the compute dtype
        weights = dropout(weights.to(q.dtype)).float()
    out = torch.matmul(weights.to(q.dtype), v).transpose(1, 2).reshape(b, sq, d)
    return out, weights


def column_in(x: torch.Tensor, group) -> torch.Tensor:
    """A column-parallel layer's input (f); ``x`` itself without a group."""
    return to_model(x, group)


def row_out(linear: Linear, x: torch.Tensor, group, out_f32: bool = False) -> torch.Tensor:
    """``linear`` applied to ``x``; with a group, ``linear`` holds a slice of
    its input columns: the ranks' partial products summed (g), the bias
    added once after the sum, all in ``linear``'s compute dtype (the sum
    with the bias in float32 with ``out_f32``)."""
    if group is None:
        return linear(x, out_f32=out_f32)
    dt = linear.compute_dtype
    y = from_model(dense(x, linear.weight, None, dt), group)
    return y.float() + linear.bias.to(dt).float() if out_f32 else y + linear.bias.to(dt)


class MultiHeadAttention(nn.Module):
    """Batch-first MHA with ``torch.nn.MultiheadAttention``'s parameter names
    (packed ``in_proj_weight``/``in_proj_bias``, ``out_proj``). Returns the
    output and the weights averaged over heads; ``dropout`` acts on the
    attention weights.

    Tensor-parallel (``model_group`` set): the rank holds ``local_heads``
    whole heads, its packed rows ``[q_r; k_r; v_r]`` and the matching input
    columns of ``out_proj``; the head mean is completed over the group."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.local_heads = num_heads
        self.model_group = None
        self.compute_dtype = dtype
        self.dropout = Dropout(dropout) if dropout > 0.0 else None
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = Linear(d_model, d_model, dtype=dtype)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, query, key, value, key_pad_mask: Optional[torch.Tensor] = None,
                out_f32: bool = False):
        """``out_f32``: the output projection's biased sum in float32,
        unrounded (read by a LayerNorm directly)."""
        group = self.model_group
        if group is not None:  # f once for each distinct input
            entered = {}
            for x in (query, key, value):
                if id(x) not in entered:
                    entered[id(x)] = column_in(x, group)
            query, key, value = (entered[id(x)] for x in (query, key, value))
        dt = self.compute_dtype
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        out, weights = attend(
            dense(query, wq, bq, dt), dense(key, wk, bk, dt), dense(value, wv, bv, dt),
            self.local_heads, key_pad_mask, self.dropout,
        )
        if group is None:
            return self.out_proj(out, out_f32=out_f32), weights.mean(dim=1).to(dt)
        return (row_out(self.out_proj, out, group, out_f32),
                from_model(weights.sum(dim=1) / self.num_heads, group).to(dt))


class MLP(nn.Module):
    """Box / sted head MLP: ReLU between layers; with ``dropout``, dropout
    after every layer, the output included (the sted head trains with 0.5
    on its logits, as the reference does)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1)
        outs = [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(Linear(i, o, dtype=dtype) for i, o in zip(dims, outs))
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

    def __init__(self, input_dim: int, output_dim: int, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc = Linear(input_dim, output_dim, dtype=dtype)
        self.layer_norm = LayerNorm(output_dim, eps=1e-12, dtype=dtype)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropout(self.layer_norm(self.fc(x, out_f32=True)))
