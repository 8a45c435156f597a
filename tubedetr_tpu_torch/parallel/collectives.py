"""The collective inventory of one step (counterpart of ``tubedetr_tpu/parallel/collectives.py``).

The JAX package reads the collectives of a compiled program from its HLO.
Here there is no HLO: ``collective_inventory(fn, mesh)`` runs ``fn`` (one
step) once and records every collective it launches, with its kind, the
mesh axes its process group spans, its tensors and the bytes a rank moves
by the ring factors of ``_RING_FACTOR`` (the JAX module's ``_ICI_FACTOR``,
plus broadcast and point-to-point).

Where the records come from: a ``TorchDispatchMode`` active over ``fn``
sees each ``c10d`` and ``_c10d_functional`` operator as it is dispatched,
with its tensors and its process group, on every thread the autograd
engine runs the backward on, so DDP's bucket all-reduces and FSDP2's
gathers and reduce-scatters are seen with the rest. A ``torch.profiler``
trace of the same run names the same operators, but its events hold
``None`` for the process group (so no axis) and no shape for a list of
tensors, and one collective shows there as two or three events (the
``c10d::`` operator, the backend's ``gloo:``/``nccl:`` event on its own
thread). The profiler runs beside the mode all the same: the top-level
``c10d::``/``_c10d_functional::`` events it counts must equal the mode's
records (``Inventory.profiler_events``), which holds the inventory to one
record a collective.

A process group maps to its axes by name: the mesh's own groups (data,
time, model, the replica group ``data x time``, the world; a pipe mesh's
pipe group), each made for its role, by identity; any other by the mesh
coordinates its ranks span. A group of one rank keeps its axis name (a
one-card run still shows which axis a collective would cross) and moves no
bytes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# op name (without namespace and overload) -> kind
_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce", "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather", "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather", "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter", "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all", "all_to_all_single": "all-to-all",
    "broadcast_": "broadcast", "broadcast": "broadcast",
    "send": "send", "recv_": "recv", "recv_any_source_": "recv",
    "gather_": "gather", "scatter_": "scatter", "reduce_": "reduce", "barrier": "barrier",
}

# bytes a rank moves, from (result bytes, group size): the ring algorithms
_RING_FACTOR = {
    "all-gather": lambda b, s: b * (s - 1) / s,  # S shards of b/S, each rank gets S-1
    "all-reduce": lambda b, s: 2.0 * b * (s - 1) / s,  # reduce-scatter + all-gather
    "reduce-scatter": lambda b, s: b * (s - 1),  # the input is S * b
    "all-to-all": lambda b, s: b * (s - 1) / s,
    "broadcast": lambda b, s: b * (s - 1) / s,  # S-1 receivers of b, over the S ranks
    "gather": lambda b, s: b * (s - 1) / s,
    "scatter": lambda b, s: b * (s - 1) / s,
    "reduce": lambda b, s: b * (s - 1) / s,
    "send": lambda b, s: float(b) if s > 1 else 0.0,
    "recv": lambda b, s: float(b) if s > 1 else 0.0,
    "barrier": lambda b, s: 0.0,
}


@dataclass
class Collective:
    """One collective launched by this rank."""

    name: str  # the operator, e.g. "c10d.allreduce_"
    kind: str
    axes: Tuple[str, ...]
    shapes: List[str]
    result_bytes: int
    group_size: int
    rank_bytes: float = 0.0

    def __post_init__(self):
        self.rank_bytes = _RING_FACTOR[self.kind](self.result_bytes, max(self.group_size, 1))


class Inventory(list):
    """The collectives of a run, in launch order; ``profiler_events``: the
    top-level collective events of the same run's ``torch.profiler`` trace."""

    profiler_events: int = 0


def mesh_axes(mesh) -> Tuple[Tuple[str, int], ...]:
    """``((axis, size), ...)`` of a ``parallel/mesh.py:Mesh`` or a
    ``parallel/pp.py:PipeMesh``, outermost first (rank-major order)."""
    if hasattr(mesh, "pipe"):
        return (("data", mesh.data), ("pipe", mesh.pipe))
    return (("data", mesh.data), ("time", mesh.time), ("model", mesh.model))


def group_axes(mesh) -> Dict[str, Tuple[str, ...]]:
    """Process group name -> the axes it spans, for the mesh's own groups:
    its role's axes of more than one rank, or all of the role's axes where
    none has (a one-rank group still names the axis it serves)."""
    sizes = dict(mesh_axes(mesh))
    names = tuple(sizes)
    table: Dict[str, Tuple[str, ...]] = {}

    def put(group, axes):
        if group is not None:
            wide = tuple(a for a in axes if sizes[a] > 1)
            table[dist.distributed_c10d._get_process_group_name(group)] = wide or axes

    put(dist.group.WORLD, names)
    if hasattr(mesh, "pipe"):
        put(mesh.group, ("pipe",))
        return table
    put(mesh.replica_group, ("data", "time"))
    put(mesh.data_group, ("data",))
    put(mesh.time_group, ("time",))
    put(mesh.model_group, ("model",))
    return table


def _axes_of_ranks(ranks: Sequence[int], mesh) -> Tuple[str, ...]:
    """The mesh axes along which ``ranks`` (global) differ."""
    axes = mesh_axes(mesh)
    sizes = [s for _, s in axes]

    def coords(r):
        out = []
        for s in reversed(sizes):
            out.append(r % s)
            r //= s
        return out[::-1]

    if any(r >= math.prod(sizes) for r in ranks):
        return ("?",)
    cs = [coords(r) for r in ranks]
    return tuple(name for i, (name, _) in enumerate(axes) if len({c[i] for c in cs}) > 1)


def _process_group(args):
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a)
            except (RuntimeError, TypeError):
                continue
    return None


def _functional_group(args):
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in args:
        if isinstance(a, str):
            try:
                return _resolve_process_group(a)
            except (RuntimeError, ValueError, KeyError):
                continue
    return None


def _peer(args, group):
    """The global rank a send or a recv names (its third argument)."""
    peer = args[2] if len(args) > 2 and isinstance(args[2], int) else None
    if peer is None or peer < 0:
        return None
    return dist.get_global_rank(group, peer)


def _describe(func, args, out, mesh, table) -> Collective:
    ns, op = func.namespace, func._opname
    kind = _KINDS[op]
    functional = ns == "_c10d_functional"
    group = _functional_group(args) if functional else _process_group(args)
    result = out if functional else args[0]
    tensors = [t for t in tree_leaves(result) if isinstance(t, torch.Tensor)]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    shapes = [f"{str(t.dtype).replace('torch.', '')}{list(t.shape)}" for t in tensors]
    if group is None:
        return Collective(f"{ns}.{op}", kind, ("?",), shapes, nbytes, 0)
    size = dist.get_world_size(group)
    if kind in ("send", "recv"):
        peer = _peer(args, group)
        ranks = [dist.get_rank(), peer] if peer is not None else dist.get_process_group_ranks(group)
        axes = _axes_of_ranks(ranks, mesh)
        return Collective(f"{ns}.{op}", kind, axes or table.get(
            dist.distributed_c10d._get_process_group_name(group), ("?",)), shapes, nbytes, 2)
    axes = table.get(dist.distributed_c10d._get_process_group_name(group))
    if axes is None:
        axes = _axes_of_ranks(dist.get_process_group_ranks(group), mesh) or ("?",)
    return Collective(f"{ns}.{op}", kind, axes, shapes, nbytes, size)


class _Recorder(TorchDispatchMode):
    def __init__(self, mesh):
        super().__init__()
        self.mesh, self.table = mesh, group_axes(mesh)
        self.records: List[Collective] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace in ("c10d", "_c10d_functional") and func._opname in _KINDS:
            self.records.append(_describe(func, args, out, self.mesh, self.table))
        return out


def _profiler_count(prof) -> int:
    """The collective operator events of a trace that no other collective
    event encloses (the backend's own events are not operators)."""
    def is_coll(e):
        ns, _, op = e.name.partition("::")
        return ns in ("c10d", "_c10d_functional") and op in _KINDS

    n = 0
    for e in prof.events():
        if not is_coll(e):
            continue
        parent, nested = e.cpu_parent, False
        while parent is not None:
            if is_coll(parent):
                nested = True
                break
            parent = parent.cpu_parent
        n += not nested
    return n


def collective_inventory(fn: Callable[[], object], mesh) -> Inventory:
    """Run ``fn()`` (one step) under the recorder and ``torch.profiler``;
    the collectives this rank launched (what ``fn`` returns is dropped: a
    caller keeps it through a closure)."""
    from torch.profiler import ProfilerActivity, profile

    rec = _Recorder(mesh)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec:
            fn()
    inv = Inventory(rec.records)
    inv.profiler_events = _profiler_count(prof)
    return inv


def summarize(colls: Sequence[Collective]) -> Dict[Tuple[str, Tuple[str, ...]], dict]:
    """Per (kind, axes): the count, the bytes a rank moves and the result
    bytes."""
    agg: Dict[Tuple[str, Tuple[str, ...]], dict] = {}
    for c in colls:
        rec = agg.setdefault((c.kind, c.axes), {"count": 0, "rank_bytes": 0.0, "result_bytes": 0})
        rec["count"] += 1
        rec["rank_bytes"] += c.rank_bytes
        rec["result_bytes"] += c.result_bytes
    return agg


def summary_json(colls: Sequence[Collective]) -> List[dict]:
    """``summarize`` as a list of plain dicts (for a JSON line)."""
    return [{"kind": k, "axes": list(a), **v} for (k, a), v in sorted(summarize(colls).items())]
