"""Tensor parallelism over the ``model`` axis, and FSDP over the data axis (counterpart of ``tubedetr_tpu/parallel/tp.py``).

The model axis (``--mesh_model``) is Megatron's split, written with plain
local slices: each rank of a ``model`` group holds its slice of each split
parameter as an ordinary tensor, and the layers put Megatron's f and g
(``core/sharding.py``) around the sharded middle (``models/layers.py``,
``models/roberta.py``). Plain slices, not DTensor placements, because the
packed ``in_proj_weight`` (q, k, v stacked, ``(3D, D)``) must give a rank
``[q_r; k_r; v_r]`` (``Shard(0)`` would give rank 0 all of q and half of
k), because ``DistributedDataParallel`` takes no DTensor parameter, and
because ZeRO-1 and the trunk's hand all-reduce work on plain tensors.

``tp_split`` is the port's copy of ``tp_spec_for_path``'s rule table, in
the reference ``state_dict`` grammar:

=========================================================  ===============================
parameter                                                  split
=========================================================  ===============================
``{self_attn,cross_attn_image}.in_proj_{weight,bias}``     rows, by heads within each of
                                                           q, k and v (``packed``)
``{self_attn,cross_attn_image}.out_proj.weight``           input columns (bias added once)
``linear1.{weight,bias}``                                  rows (the FFN's middle)
``linear2.weight``                                         input columns
RoBERTa ``attention.self.{query,key,value}.*``             rows, by heads
RoBERTa ``attention.output.dense.weight``                  input columns
RoBERTa ``intermediate.dense.{weight,bias}``               rows
RoBERTa ``layer.N.output.dense.weight``                    input columns
RoBERTa ``{word,position,token_type}_embeddings.weight``   the hidden dim
norms, heads, trunk, time and query embeddings             replicated
=========================================================  ===============================

The fast branch's encoder layer (``fast_mode="transformer"``) follows the
encoder's rules. An attention whose heads (``nheads``, or ``text_heads``
for RoBERTa) do not divide by the model size stays replicated, and so does
any dim that does not divide. Dropout in the sharded middle (the attention
weights, the FFN's hidden units) draws from the generator every model rank
shares: rank ``r``'s slice gets the mask rank 0 draws for its own slice,
not one process's mask of those units (parity is held on the dropout-free
step).

``count_tp_sharded`` counts in the JAX package's leaves: a packed
``in_proj_*`` is three (its q, k and v). ``shard_tp`` cuts a train state in
place (parameters, AdamW moments, EMA) after ``sync_from_rank0``;
``place_variables_tp`` cuts an inference model; ``gather_named`` puts the
slices of a named dict back together (a collective over the model group).

FSDP (``shard_train_state``) applies FSDP2's ``fully_shard`` over the mesh's
``data`` dimension to each layer of the space-text encoder, the decoder and
RoBERTa, then to the whole model with the conv trunk left out
(``ignored_params``), as the JAX package exempts the backbone: its
gradients are averaged by hand (``Parallel.after_backward``). Under tensor
parallelism it shards the rank's slices again. The parameters become
DTensors sharded along their first axis; the AdamW moments and the EMA
follow them (``shard_params`` implies ``shard_optimizer_state``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
from torch import nn

from tubedetr_tpu_torch.models.roberta import RobertaLayer
from tubedetr_tpu_torch.models.transformer import DecoderLayer, EncoderLayer


@dataclass(frozen=True)
class Split:
    """A parameter cut along ``dim``; ``packed``: the dim stacks q, k and v,
    each cut alike."""

    dim: int
    packed: bool = False


# (name pattern, dim, packed, whose heads must divide: "" none, "nheads", "text")
_RULES = (
    (re.compile(r"(self_attn|cross_attn_image)\.in_proj_(weight|bias)$"), 0, True, "nheads"),
    (re.compile(r"(self_attn|cross_attn_image)\.out_proj\.weight$"), 1, False, "nheads"),
    (re.compile(r"(^|\.)linear1\.(weight|bias)$"), 0, False, ""),
    (re.compile(r"(^|\.)linear2\.weight$"), 1, False, ""),
    (re.compile(r"attention\.self\.(query|key|value)\.(weight|bias)$"), 0, False, "text"),
    (re.compile(r"attention\.output\.dense\.weight$"), 1, False, "text"),
    (re.compile(r"intermediate\.dense\.(weight|bias)$"), 0, False, ""),
    (re.compile(r"layer\.\d+\.output\.dense\.weight$"), 1, False, ""),
    (re.compile(r"embeddings\.(word|position|token_type)_embeddings\.weight$"), -1, False, ""),
)


def tp_split(name: str, shape, model: int, nheads: int, text_heads: int) -> Optional[Split]:
    """How the ``model``-way axis cuts the parameter ``name`` of ``shape``:
    a ``Split``, or None (replicated). ``model = 1`` gives the split a wider
    mesh would (each slice whole), so a one-rank group drives the sharded
    code; ``count_tp_sharded`` counts nothing then, as the JAX package."""
    for pattern, dim, packed, heads in _RULES:
        if not pattern.search(name):
            continue
        if heads and {"nheads": nheads, "text": text_heads}[heads] % model:
            return None
        dim = dim % len(shape)
        if shape[dim] % (model * (3 if packed else 1)):
            return None
        return Split(dim, packed)
    return None


def tp_splits(model: nn.Module, size: int, nheads: int, text_heads: int) -> Dict[str, Split]:
    """Each split parameter of ``model`` (whole) by name."""
    out = {}
    for n, p in model.named_parameters():
        s = tp_split(n, tuple(p.shape), size, nheads, text_heads)
        if s is not None:
            out[n] = s
    return out


def count_tp_sharded(model: nn.Module, size: int, nheads: int, text_heads: int) -> int:
    """The number of JAX parameter leaves the ``size``-way rules shard (a
    packed ``in_proj_*`` counts its q, k and v); 0 for ``size <= 1``."""
    if size <= 1:
        return 0
    return sum(3 if s.packed else 1 for s in tp_splits(model, size, nheads, text_heads).values())


def cut(t: torch.Tensor, split: Split, size: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s slice of the whole ``t`` (a new contiguous tensor)."""
    if split.packed:
        t = torch.cat([x.chunk(size, dim=split.dim)[rank] for x in t.chunk(3, dim=split.dim)],
                      dim=split.dim)
    else:
        t = t.chunk(size, dim=split.dim)[rank]
    return t.clone(memory_format=torch.contiguous_format)


def join(parts: List[torch.Tensor], split: Split) -> torch.Tensor:
    """The whole tensor from every rank's slice, in rank order."""
    if split.packed:
        thirds = [p.chunk(3, dim=split.dim) for p in parts]
        return torch.cat([torch.cat([t[i] for t in thirds], dim=split.dim) for i in range(3)],
                         dim=split.dim)
    return torch.cat(parts, dim=split.dim)


@dataclass
class TPLayout:
    """A model's tensor-parallel layout: its split parameters, the group
    and this rank's place in it."""

    splits: Dict[str, Split]
    group: object
    size: int
    rank: int


def _engage(model: nn.Module, layout: TPLayout) -> None:
    """Point the layers whose weights are split at the model group (and the
    attention layers at their local heads)."""
    from tubedetr_tpu_torch.models.layers import MultiHeadAttention
    from tubedetr_tpu_torch.models.roberta import (
        RobertaAttention,
        RobertaEmbeddings,
    )

    split = layout.splits
    for prefix, m in model.named_modules():
        pre = f"{prefix}." if prefix else ""
        if isinstance(m, MultiHeadAttention) and f"{pre}in_proj_weight" in split:
            m.model_group, m.local_heads = layout.group, m.num_heads // layout.size
        elif isinstance(m, (EncoderLayer, DecoderLayer)) and f"{pre}linear1.weight" in split:
            m.model_group = layout.group
        elif isinstance(m, RobertaAttention) and f"{pre}self.query.weight" in split:
            m.model_group = layout.group
            m.self.local_heads = m.self.num_heads // layout.size
        elif isinstance(m, RobertaLayer) and f"{pre}intermediate.dense.weight" in split:
            m.model_group = layout.group
        elif isinstance(m, RobertaEmbeddings) and f"{pre}word_embeddings.weight" in split:
            m.model_group = layout.group


@torch.no_grad()
def place_variables_tp(model: nn.Module, mesh, cfg) -> TPLayout:
    """Cut ``model``'s whole weights to this rank's slices in place (each
    parameter keeps its identity) and engage its split layers; the layout
    is kept as ``model.tp_layout``. Buffers stay replicated."""
    size = mesh.model
    splits = tp_splits(model, size, cfg.nheads, cfg.text_heads)
    layout = TPLayout(splits, mesh.model_group, size, mesh.model_rank)
    params = dict(model.named_parameters())
    for n, s in splits.items():
        params[n].data = cut(params[n].data, s, size, mesh.model_rank)
    _engage(model, layout)
    model.tp_layout = layout
    return layout


@torch.no_grad()
def shard_tp(cfg, state, mesh) -> TPLayout:
    """Tensor parallelism on a whole train state, in place: the model's
    split parameters, their AdamW moments and their EMA cut to this rank's
    slices. Every rank must hold the same whole state first
    (``sync_from_rank0``)."""
    layout = place_variables_tp(state.model, mesh, cfg)
    params = dict(state.model.named_parameters())
    if state.optimizer is not None:
        for n, s in layout.splits.items():
            st = state.optimizer.state.get(params[n])
            for k, v in (st or {}).items():
                if torch.is_tensor(v) and v.dim() > 0:
                    st[k] = cut(v, s, layout.size, layout.rank)
    if state.ema_params is not None:
        for n, s in layout.splits.items():
            if n in state.ema_params:
                state.ema_params[n] = cut(state.ema_params[n], s, layout.size, layout.rank)
    return layout


def gather_named(tensors: Dict[str, torch.Tensor], layout: Optional[TPLayout]) -> Dict:
    """``tensors`` (by parameter name, this rank's slices) with each split
    one put back whole (an all-gather over the model group a tensor, in the
    names' order: every rank of the group passes the same names); the
    others as they are. ``tensors`` itself without a layout."""
    if layout is None:
        return tensors
    import torch.distributed as dist

    nccl = dist.get_backend(layout.group) == "nccl"
    out = dict(tensors)
    for n in sorted(tensors):
        s = layout.splits.get(n)
        if s is None or tensors[n] is None:
            continue
        t = tensors[n].detach()
        # NCCL gathers on the card: a host copy (a checkpoint's moments) goes there and back
        local = (t.cuda() if nccl else t.cpu()).contiguous()
        parts = [torch.empty_like(local) for _ in range(layout.size)]
        dist.all_gather(parts, local, group=layout.group)
        out[n] = join(parts, s).to(t.device)
    return out


def tp_layout_of(model: nn.Module) -> Optional[TPLayout]:
    return getattr(model, "tp_layout", None)


# ---------------------------------------------------------------------------
# FSDP over the data axis
# ---------------------------------------------------------------------------


def fsdp_units(model: nn.Module) -> List[nn.Module]:
    """The layers that FSDP shards one by one: every encoder, decoder and
    RoBERTa layer (the fast branch's encoder layer included)."""
    return [m for m in model.transformer.modules()
            if isinstance(m, (EncoderLayer, DecoderLayer, RobertaLayer))]


def is_sharded(t) -> bool:
    return hasattr(t, "full_tensor")


def full(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of an FSDP shard (an all-gather over its mesh, a
    collective), any other tensor itself."""
    return t.full_tensor() if is_sharded(t) else t


def shard_like(value: torch.Tensor, param) -> torch.Tensor:
    """``value``, a whole tensor shaped as ``param``, laid out as ``param``
    is: a DTensor on its mesh with its placements, or itself on its device."""
    if not is_sharded(param):
        return value.to(param.device)
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(value.to(param.to_local().device), param.device_mesh, param.placements)


def shard_train_state(cfg, state, mesh) -> None:
    """FSDP: ``state.model`` sharded over ``mesh``'s data dimension in
    place, its optimizer rebuilt over the sharded parameters (the moments
    carried over, sharded), its EMA sharded likewise."""
    from torch.distributed.fsdp import fully_shard

    from tubedetr_tpu_torch.train.optim import (
        build_optimizer,
        move_optimizer_state,
        optimizer_names,
    )

    model, old = state.model, state.optimizer
    old_names = optimizer_names(old, model)  # before fully_shard swaps the parameters
    data_mesh = mesh.data_mesh
    for unit in fsdp_units(model):
        fully_shard(unit, mesh=data_mesh)
    fully_shard(model, mesh=data_mesh, ignored_params=set(model.backbone.parameters()))
    params = dict(model.named_parameters())
    optimizer, _ = build_optimizer(cfg, model)
    new_names = optimizer_names(optimizer, model)
    move_optimizer_state(old, old_names, optimizer, new_names,
                         convert=lambda v, i: shard_like(v, params[new_names[i]]))
    state.optimizer = optimizer
    if state.ema_params is not None:
        state.ema_params = {n: shard_like(t, params[n]) for n, t in state.ema_params.items()}
