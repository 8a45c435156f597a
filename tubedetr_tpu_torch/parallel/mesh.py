"""The ``(data, time, model)`` process mesh and ZeRO-1 (counterpart of ``tubedetr_tpu/parallel/mesh.py``).

* ``make_mesh(data, time, device_type, model)`` lays the ranks out
  data-major with ``model`` innermost, as the JAX package reshapes its
  devices ``(data, time, model)``: rank ``r`` is model rank ``r % model``,
  time rank ``(r // model) % time`` and data rank ``r // (time * model)``,
  so a model group's ranks (a collective a layer) are neighbours on one
  node. Each process group is made for its role (``new_groups``): a
  ``data`` group holds the ranks of one (time, model) index (they read
  different samples), a ``time`` group the ranks of one (data, model) index
  (they read the same samples and split their frames), a ``model`` group
  the ranks of one (data, time) index (they hold the slices of one layer,
  ``parallel/tp.py``), the ``replica`` group the ``data x time`` ranks of
  one model index (they hold the same weights, so DDP and the trunk's hand
  all-reduce average over it). With ``model = 1`` the groups hold the ranks
  of the ``(data, time)`` mesh, the replica group all of them; every group is named where it is
  used, none is the default one, so a collective's group says which axis
  it serves (``parallel/collectives.py``).
* ``mesh_shape`` widens the data axis to span every process, as the JAX CLI
  does: ``data = world // (time * model)``.
* ``ZeroPartition`` and ``shard_opt_state_along_data`` (ZeRO-1): each
  parameter has one owner among the data ranks, assigned greedily by size
  (as ``ZeroRedundancyOptimizer`` places whole parameters; the JAX package
  cuts each leaf along its first divisible axis instead, and either
  placement computes the same elementwise update). A rank keeps the AdamW
  moments and the EMA of what it owns, steps those parameters, and
  broadcasts them to the other data ranks after the step; the parameters
  themselves stay replicated. ``gather`` re-replicates the EMA for the
  evaluation and the checkpoint. Under tensor parallelism the partition is
  of the rank's own slices, within its data group.
* ``full_state_dicts`` and ``gather_state`` give back the one-process
  layout: sharded states are gathered over the data group (FSDP, ZeRO-1),
  then tensor-parallel slices over the model group (``tp.gather_named``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from tubedetr_tpu_torch.parallel import dist as tdist


@dataclass
class Mesh:
    """The axes' sizes, this rank's place on them and their process groups
    (None for one process); ``data_mesh`` is the data group as a 1-D
    ``DeviceMesh`` (FSDP2's)."""

    data: int = 1
    time: int = 1
    data_rank: int = 0
    time_rank: int = 0
    data_group: Optional[object] = None
    time_group: Optional[object] = None
    data_mesh: Optional[object] = None
    model: int = 1
    model_rank: int = 0
    model_group: Optional[object] = None
    replica_group: Optional[object] = None

    @property
    def distributed(self) -> bool:
        return self.data_mesh is not None


def new_groups(member_sets: List[List[int]]):
    """``dist.new_group`` for each rank list, on every rank in the same
    order (each call is collective); returns the group holding this rank."""
    rank, mine = dist.get_rank(), None
    for ranks in member_sets:
        g = dist.new_group(ranks)
        if rank in ranks:
            mine = g
    return mine


def mesh_shape(cfg, world: int) -> tuple:
    """(data, time, model) for ``world`` processes: the data axis spans
    every process, ``world // (mesh_time * mesh_model)`` (a different
    ``--mesh_data`` is widened with a line that says so); one process runs a
    1 x 1 x 1 mesh."""
    time, model = cfg.mesh_time, cfg.mesh_model
    if world == 1:
        if cfg.mesh_data not in (1, -1) or time != 1 or model != 1:
            raise ValueError(
                f"mesh {cfg.mesh_data} x {time} x {model} needs "
                f"{max(cfg.mesh_data, 1) * time * model} processes, "
                "one a card: launch them with torchrun --nproc_per_node N (or srun)")
        return 1, 1, 1
    if world % (time * model):
        raise ValueError(f"mesh_time * mesh_model = {time} * {model} does not divide the "
                         f"{world} processes")
    data = world // (time * model)
    if cfg.mesh_data not in (1, -1, data):
        print(f"[mesh] widening data axis {cfg.mesh_data} -> {data} to span all {world} processes")
    return data, time, model


def make_mesh(data: int, time: int, device_type: str, model: int = 1) -> Mesh:
    """The ``(data, time, model)`` mesh over the default process group
    (which must hold ``data * time * model`` ranks), or the 1 x 1 x 1 mesh
    without one."""
    if not tdist.is_dist_initialized():
        if (data, time, model) != (1, 1, 1):
            raise ValueError(f"a {data} x {time} x {model} mesh needs a process group")
        return Mesh()
    world = dist.get_world_size()
    if data * time * model != world:
        raise ValueError(f"a {data} x {time} x {model} mesh needs {data * time * model} ranks, "
                         f"the group has {world}")
    from torch.distributed.device_mesh import DeviceMesh

    def rank_of(d, t, m):
        return (d * time + t) * model + m

    # a group of its own for each role, even where two roles hold the same
    # ranks: a collective's group then names the axis it serves
    data_group = new_groups([[rank_of(d, t, m) for d in range(data)]
                             for t in range(time) for m in range(model)])
    time_group = new_groups([[rank_of(d, t, m) for t in range(time)]
                             for d in range(data) for m in range(model)])
    model_group = new_groups([[rank_of(d, t, m) for m in range(model)]
                              for d in range(data) for t in range(time)])
    replica = new_groups([list(range(m, world, model)) for m in range(model)])
    rank = dist.get_rank()
    data_mesh = DeviceMesh.from_group(data_group, device_type, mesh_dim_names=("data",))
    return Mesh(data, time, rank // (time * model), (rank // model) % time, data_group,
                time_group, data_mesh, model, rank % model, model_group, replica)


class ZeroPartition:
    """Each named tensor's owner among the ``size`` ranks of a data group,
    the largest placed first on the least loaded rank (ties to the lower
    rank, names in order: every rank computes the same partition)."""

    def __init__(self, shapes: Dict[str, torch.Size], mesh: Mesh):
        self.group, self.rank, self.size = mesh.data_group, mesh.data_rank, mesh.data
        self.names = list(shapes)
        load = [0] * self.size
        self.owner: Dict[str, int] = {}
        for n in sorted(self.names, key=lambda n: -int(torch.Size(shapes[n]).numel())):
            r = min(range(self.size), key=lambda i: (load[i], i))
            self.owner[n] = r
            load[r] += int(torch.Size(shapes[n]).numel())
        self.sources = ([dist.get_global_rank(self.group, r) for r in range(self.size)]
                        if self.group is not None else [0])

    def owns(self, name: str) -> bool:
        return self.owner[name] == self.rank

    def owned(self) -> List[str]:
        return [n for n in self.names if self.owns(n)]

    def gather(self, local: Dict[str, torch.Tensor], template: Dict[str, torch.Tensor],
               into: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """Every tensor of ``template``'s names, each its owner's: ``local``
        holds what this rank owns (shaped as ``template``'s), the others
        come by one broadcast an owner and dtype, flattened. With ``into``
        the received tensors are copied into ``into``'s tensors in place
        (the parameters after a ZeRO step) and ``into`` is returned."""
        out = dict(into) if into is not None else {}
        for r in range(self.size):
            names = [n for n in template if self.owner[n] == r]
            for dtype in sorted({template[n].dtype for n in names}, key=str):
                group = [n for n in names if template[n].dtype == dtype]
                like = [template[n] for n in group]
                if r == self.rank:
                    flat = _flatten_dense_tensors([local[n].detach() for n in group])
                else:
                    flat = torch.empty(sum(t.numel() for t in like), dtype=dtype,
                                       device=like[0].device)
                if self.size > 1:
                    dist.broadcast(flat, src=self.sources[r], group=self.group)
                if r == self.rank:
                    if into is None:
                        out.update({n: local[n] for n in group})
                    continue
                for n, t in zip(group, _unflatten_dense_tensors(flat, like)):
                    if into is not None:
                        into[n].copy_(t)
                    else:
                        out[n] = t
        return out


def shard_opt_state_along_data(cfg, state, mesh: Mesh):
    """ZeRO-1: ``state``'s optimizer rebuilt over the parameters this data
    rank owns (their moments carried over) and its EMA cut to them; every
    parameter, frozen ones included, has an owner for the EMA. Returns the
    partition."""
    from tubedetr_tpu_torch.train.optim import (
        build_optimizer,
        move_optimizer_state,
        optimizer_names,
    )

    model = state.model
    zero = ZeroPartition({n: p.shape for n, p in model.named_parameters()}, mesh)
    owned = set(zero.owned())
    optimizer, _ = build_optimizer(cfg, model, only=owned)
    move_optimizer_state(state.optimizer, optimizer_names(state.optimizer, model), optimizer,
                         optimizer_names(optimizer, model))
    state.optimizer = optimizer
    if state.ema_params is not None:
        state.ema_params = {n: t for n, t in state.ema_params.items() if n in owned}
    return zero


def gather_ema(state) -> Optional[Dict[str, torch.Tensor]]:
    """The whole EMA on every rank (a collective under ZeRO-1; the state's
    own dict otherwise)."""
    zero = state.parallel.zero if state.parallel is not None else None
    if state.ema_params is None or zero is None:
        return state.ema_params
    return zero.gather(state.ema_params, {n: p.data for n, p in state.model.named_parameters()})


def gather_state(state):
    """A ``TrainState`` for the evaluation, replicated over the data axis (a
    collective when the state is sharded; ``state`` itself when it is not):
    under ZeRO-1 the model with the whole EMA; under FSDP an unsharded copy
    of the model (made once, then refilled) with the whole weights and EMA,
    so that ranks with different batch counts never wait on each other's
    all-gathers. Tensor-parallel slices stay sliced: the evaluation runs on
    them, as the JAX CLI's does. It has no optimizer."""
    from tubedetr_tpu_torch.parallel.tp import full, place_variables_tp, tp_layout_of
    from tubedetr_tpu_torch.parallel.train_step import TrainState

    par = state.parallel
    if par is None or (par.zero is None and not par.fsdp):
        return state
    if not par.fsdp:
        return TrainState(state.model, None, state.labels, gather_ema(state), state.step)
    weights = {k: full(v) for k, v in state.model.state_dict().items()}
    if par.plain is None:
        from tubedetr_tpu_torch.models.tubedetr import TubeDETR

        device = next(state.model.backbone.parameters()).device
        par.plain = TubeDETR(state.model.cfg).eval().to(device)
        par.plain.time_group = state.model.time_group
        if tp_layout_of(state.model) is not None:
            place_variables_tp(par.plain, par.mesh, state.model.cfg)
    par.plain.load_state_dict(weights)
    ema = None if state.ema_params is None else {n: full(t) for n, t in state.ema_params.items()}
    return TrainState(par.plain, None, state.labels, ema, state.step)


def full_state_dicts(state):
    """``(model state_dict, EMA, optimizer state_dict)`` of ``state`` as one
    process would hold them, whole (the optimizer's in one process's
    layout, ``train/optim.py:optimizer_state_dict``): a collective when the
    state is sharded. Under ZeRO-1 only data rank 0 receives the optimizer
    state (None elsewhere). Tensor-parallel slices are gathered over the
    model group after the data axis's gather."""
    from tubedetr_tpu_torch.parallel.tp import gather_named, tp_layout_of
    from tubedetr_tpu_torch.train.optim import param_layout

    model_sd, ema, opt_sd = _data_state_dicts(state)
    layout = tp_layout_of(state.model)
    if layout is None:
        return model_sd, ema, opt_sd
    model_sd = gather_named(model_sd, layout)
    ema = None if ema is None else gather_named(ema, layout)
    if opt_sd is not None:  # one process's optimizer order: param_layout's
        names = [n for _, ns in param_layout(state.labels) for n in ns]
        per = {}  # the moments by kind, then by name (a step count stays)
        for i, st in opt_sd["state"].items():
            for k, v in st.items():
                if torch.is_tensor(v) and v.dim() > 0:
                    per.setdefault(k, {})[names[i]] = v
        per = {k: gather_named(d, layout) for k, d in sorted(per.items())}
        opt_sd = {"state": {i: {k: per[k][names[i]] if names[i] in per.get(k, {}) else v
                                for k, v in st.items()}
                            for i, st in opt_sd["state"].items()},
                  "param_groups": opt_sd["param_groups"]}
    return model_sd, ema, opt_sd


def _data_state_dicts(state):
    """``full_state_dicts`` over the data axis alone: each tensor as its
    model rank holds it."""
    from tubedetr_tpu_torch.parallel.tp import full
    from tubedetr_tpu_torch.train.optim import (
        named_optimizer_state,
        optimizer_names,
        optimizer_state_dict,
    )

    par, model, opt = state.parallel, state.model, state.optimizer
    model_sd = model.state_dict()
    opt_sd = None if opt is None else opt.state_dict()
    if par is None or (par.zero is None and not par.fsdp):
        return model_sd, state.ema_params, opt_sd
    if par.fsdp:
        ema = None if state.ema_params is None else {n: full(t) for n, t in state.ema_params.items()}
        if opt_sd is not None:
            opt_sd = {"state": {i: {k: full(v) if torch.is_tensor(v) else v for k, v in st.items()}
                                for i, st in opt_sd["state"].items()},
                      "param_groups": opt_sd["param_groups"]}
        return {k: full(v) for k, v in model_sd.items()}, ema, opt_sd
    ema = gather_ema(state)
    if opt is None:
        return model_sd, ema, None
    from tubedetr_tpu_torch.train.checkpoint import snapshot

    local = snapshot(named_optimizer_state(opt, optimizer_names(opt, model)))
    zero = par.zero
    parts = [None] * zero.size if zero.rank == 0 else None
    dist.gather_object(local, parts, dst=zero.sources[0], group=zero.group)
    if zero.rank != 0:
        return model_sd, ema, None
    named, hypers = {}, {}
    for st, hy in parts:
        named.update(st)
        hypers.update(hy)
    return model_sd, ema, optimizer_state_dict(named, hypers, state.labels)
