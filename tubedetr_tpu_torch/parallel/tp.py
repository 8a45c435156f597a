"""FSDP over the data axis (counterpart of ``shard_train_state(..., fsdp=True)`` in ``tubedetr_tpu/parallel/tp.py``).

``shard_train_state`` applies FSDP2's ``fully_shard`` over the mesh's
``data`` dimension to each layer of the space-text encoder, the decoder and
RoBERTa, then to the whole model with the conv trunk left out
(``ignored_params``), as the JAX package exempts the backbone: its
gradients are averaged by hand (``Parallel.after_backward``). The
parameters become DTensors sharded along their first axis; the AdamW
moments and the EMA follow them (``shard_params`` implies
``shard_optimizer_state``). The tensor-parallel half of the JAX module
(``tp_spec_for_path``, the ``model`` axis) waits for ROADMAP item 15's
next slice: ``TubeDETRConfig.validate`` refuses ``mesh_model > 1``.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from tubedetr_tpu_torch.models.roberta import RobertaLayer
from tubedetr_tpu_torch.models.transformer import DecoderLayer, EncoderLayer


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
    data_mesh = mesh.device_mesh["data"]
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
