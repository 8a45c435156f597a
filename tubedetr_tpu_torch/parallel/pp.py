"""Pipeline parallelism: GPipe over a ``pipe`` process group (counterpart of ``tubedetr_tpu/parallel/pp.py``).

A stack of ``L`` identical layers (an ``nn.ModuleList``) is cut into ``P``
stages of ``L / P`` contiguous layers (``L % P != 0`` is refused), a stage a
rank of the ``pipe`` group; the independent work units (clips for the
encoder, videos for the decoder) are grouped into ``M`` microbatches. Every
rank walks the same ``M + P - 1`` ticks: at tick ``t`` stage ``s`` runs
microbatch ``t - s`` (stage 0 takes it from ``x``, the others receive it
from stage ``s - 1``) and sends its output one hop on; a bubble tick does
nothing. The last stage collects the outputs and one broadcast leaves them
on every stage, as the JAX ``psum`` does. ``aux`` (positions, masks, the
decoder's memory) never travels: each stage slices it by the microbatch it
holds. With ``collect`` each stage keeps its own layers' extras and one
all-gather assembles the stage-ordered ``(L, N, ...)`` stacks.

It is differentiable: the whole schedule is one ``autograd.Function`` whose
backward walks the microbatches in reverse, receiving each output's
gradient from the next stage, running ``autograd.grad`` through the stage's
saved graph and sending the input's gradient back. The result is one
value replicated over the stages (every stage computes the same loss from
it), so the last stage's own cotangent is the gradient; the gradient of
``x`` (stage 0's) is broadcast, that of ``aux`` summed over the stages,
and each stage's layers get their own parameters' gradients.

Why a hand-written schedule on ``isend``/``irecv`` and not
``torch.distributed.pipelining``: its ``PipelineStage`` chunks every
positional argument and sends what a stage returns to the next one, so
``aux`` would travel with the activation and the per-layer extras would
ride the hops; here ``aux`` stays put and the extras are gathered once, as
in the JAX module, in about as much code as the adapters would take.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.utils import _pytree as pytree


@dataclass
class PipeMesh:
    """A ``(data, pipe)`` layout: ``pipe`` innermost (a stage's hops stay on
    one node); this rank's stage and data index, and its pipe group (None
    for one process)."""

    pipe: int = 1
    data: int = 1
    stage: int = 0
    data_rank: int = 0
    group: Optional[object] = None

    def global_rank(self, stage: int) -> int:
        return dist.get_global_rank(self.group, stage)


def make_pipe_mesh(pipe: int, data: int = 1) -> PipeMesh:
    """The ``(data, pipe)`` mesh over the default process group (which must
    hold ``data * pipe`` ranks), a pipe group of its own for each data
    index; one process gets the 1 x 1 mesh."""
    if not (dist.is_available() and dist.is_initialized()):
        if (pipe, data) != (1, 1):
            raise ValueError(f"a {data} x {pipe} pipe mesh needs a process group")
        return PipeMesh()
    world = dist.get_world_size()
    if pipe * data != world:
        raise ValueError(f"a {data} x {pipe} pipe mesh needs {data * pipe} ranks, the group has "
                         f"{world}")
    from tubedetr_tpu_torch.parallel.mesh import new_groups

    rank = dist.get_rank()
    group = new_groups([[d * pipe + s for s in range(pipe)] for d in range(data)])
    return PipeMesh(pipe, data, rank % pipe, rank // pipe, group)


def stack_layer_params(layers: Sequence[nn.Module]) -> nn.ModuleList:
    """The ``(L, ...)`` stack the pipeline consumes: the layers in order."""
    return layers if isinstance(layers, nn.ModuleList) else nn.ModuleList(layers)


def _stage_range(n_layers: int, n_stages: int, stage: int) -> range:
    """Stage ``stage``'s contiguous layers (``_to_stage_major``)."""
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers do not split over {n_stages} stages")
    per = n_layers // n_stages
    return range(stage * per, (stage + 1) * per)


class PlacedStack(nn.Module):
    """This stage's layers of an ``n_layers`` stack (the others dropped:
    their memory stays with their own stages)."""

    def __init__(self, layers: List[nn.Module], n_layers: int, stage: int):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.n_layers, self.stage = n_layers, stage


def place_stacked_params(stack: nn.ModuleList, mesh: PipeMesh) -> PlacedStack:
    """Keep only this rank's stage of ``stack``."""
    layers = [stack[i] for i in _stage_range(len(stack), mesh.pipe, mesh.stage)]
    return PlacedStack(layers, len(stack), mesh.stage)


def _local_layers(stack, mesh: PipeMesh) -> List[nn.Module]:
    if isinstance(stack, PlacedStack):
        if stack.stage != mesh.stage or stack.n_layers % mesh.pipe:
            raise ValueError("the stack was placed for another stage or pipe size")
        return list(stack.layers)
    return [stack[i] for i in _stage_range(len(stack), mesh.pipe, mesh.stage)]


class _Run:
    """What the schedule needs besides its tensor inputs."""

    def __init__(self, layer_fn, layers, mesh, m, collect, aux_spec, n_aux, n_layers):
        self.layer_fn, self.layers, self.mesh, self.m = layer_fn, layers, mesh, m
        self.collect, self.aux_spec, self.n_aux, self.n_layers = collect, aux_spec, n_aux, n_layers
        self.extras_spec = None

    def stage(self, y, aux):
        """This stage's layers on one microbatch: (y, [per layer: flat extras])."""
        aux = pytree.tree_unflatten(aux, self.aux_spec)
        extras = []
        for layer in self.layers:
            if self.collect:
                y, e = self.layer_fn(layer, y, aux)
                flat, self.extras_spec = pytree.tree_flatten(e)
                extras.append(flat)
            else:
                y = self.layer_fn(layer, y, aux)
        return y, extras


def _p2p(op, t: torch.Tensor, mesh: PipeMesh, stage: int):
    return op(t, mesh.global_rank(stage), group=mesh.group)


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run: _Run, x, *rest):
        mesh, m = run.mesh, run.m
        aux, params = rest[:run.n_aux], rest[run.n_aux:]
        s, p = mesh.stage, mesh.pipe
        mb = x.shape[0] // m
        grad_on = x.requires_grad or any(t.requires_grad for t in rest)
        saved, outs, sends, extras = {}, [None] * m, [], [None] * m
        for t in range(m + p - 1):
            i = t - s
            if not 0 <= i < m:
                continue  # a bubble
            if s == 0:
                inp = x[i * mb:(i + 1) * mb]
            else:
                inp = torch.empty((mb,) + x.shape[1:], dtype=x.dtype, device=x.device)
                _p2p(dist.recv, inp, mesh, s - 1)
            inp = inp.detach().requires_grad_(True)
            aux_i = [a[i * mb:(i + 1) * mb].detach().requires_grad_(a.requires_grad) for a in aux]
            with torch.enable_grad():
                y, ext = run.stage(inp, aux_i)
            if s < p - 1:
                sends.append(_p2p(dist.isend, y.detach().contiguous(), mesh, s + 1))
            else:
                outs[i] = y.detach()
            extras[i] = ext
            saved[i] = (inp, aux_i, y, ext)
        for req in sends:
            req.wait()
        out = (torch.cat(outs) if s == p - 1
               else torch.empty_like(x))
        if mesh.group is not None:  # the last stage's result on every stage
            dist.broadcast(out, src=mesh.global_rank(p - 1), group=mesh.group)
        results = [out]
        if run.collect:  # (L/P, N, ...) a leaf on this stage, gathered stage-major
            for j in range(len(extras[0][0])):
                local = torch.cat([torch.stack([e[j].detach() for e in extras[i]]) for i in range(m)],
                                  dim=1).contiguous()
                if mesh.group is None:
                    results.append(local)
                    continue
                parts = [torch.empty_like(local) for _ in range(p)]
                dist.all_gather(parts, local, group=mesh.group)
                results.append(torch.cat(parts))
        ctx.run, ctx.saved, ctx.mb = run, (saved if grad_on else None), mb
        ctx.x_meta = (x.shape, x.dtype, x.device)
        ctx.aux_meta = [(a.shape, a.dtype, a.requires_grad) for a in aux]
        ctx.params = params
        return tuple(results)

    @staticmethod
    def backward(ctx, grad_out, *grad_extras):
        run, mb = ctx.run, ctx.mb
        mesh, m = run.mesh, run.m
        s, p = mesh.stage, mesh.pipe
        per = run.n_layers // p
        shape, dtype, device = ctx.x_meta
        grad_x = torch.zeros(shape, dtype=dtype, device=device)
        grad_aux = [torch.zeros(sh, dtype=dt, device=device) if rg else None
                    for sh, dt, rg in ctx.aux_meta]
        grad_params = [None] * len(ctx.params)
        sends = []
        for i in reversed(range(m)):
            inp, aux_i, y, ext = ctx.saved[i]
            rows = slice(i * mb, (i + 1) * mb)
            if s == p - 1:
                gy = grad_out[rows]
            else:
                gy = torch.empty_like(y)
                _p2p(dist.recv, gy, mesh, s + 1)
            outputs, grads = [y], [gy]
            for li, flat in enumerate(ext):  # this stage's layers' extras
                for j, e in enumerate(flat):
                    if e.requires_grad:
                        outputs.append(e)
                        grads.append(grad_extras[j][s * per + li, rows])
            inputs = [inp] + [a for a in aux_i if a.requires_grad] + [
                q for q in ctx.params if q.requires_grad]
            got = torch.autograd.grad(outputs, inputs, grads, allow_unused=True)
            g_inp, rest = got[0], list(got[1:])
            g_inp = torch.zeros_like(inp) if g_inp is None else g_inp
            if s > 0:
                sends.append(_p2p(dist.isend, g_inp.contiguous(), mesh, s - 1))
            else:
                grad_x[rows] = g_inp
            for k, a in enumerate(aux_i):
                if a.requires_grad:
                    g = rest.pop(0)
                    if g is not None:
                        grad_aux[k][rows] += g
            for k, q in enumerate(ctx.params):
                if q.requires_grad:
                    g = rest.pop(0)
                    if g is not None:
                        grad_params[k] = g if grad_params[k] is None else grad_params[k] + g
        for req in sends:
            req.wait()
        if mesh.group is not None:
            dist.broadcast(grad_x, src=mesh.global_rank(0), group=mesh.group)
            for g in grad_aux:
                if g is not None:
                    dist.all_reduce(g, group=mesh.group)
        ctx.saved = None
        return (None, grad_x, *grad_aux, *grad_params)


def pipeline_apply(layer_fn: Callable, stack, x: torch.Tensor, aux, *, mesh: PipeMesh,
                   microbatches: int, collect: bool = False):
    """``x`` through a stack of L identical layers, pipelined over
    ``mesh``'s pipe group.

    ``layer_fn(layer, y, aux_m) -> y``: one layer; ``y`` keeps its shape.
    ``aux_m`` is the microbatch's slice of ``aux`` (any pytree of ``(N,
    ...)`` tensors). ``stack``: the whole ``nn.ModuleList`` (each stage runs
    its slice) or this stage's ``place_stacked_params``. ``x``: ``(N, ...)``
    with ``N % microbatches == 0``. Returns ``(N, ...)`` on every stage,
    equal to ``for layer in stack: y = layer_fn(layer, y, aux)``.

    ``collect=True``: ``layer_fn -> (y, extra)`` with ``extra`` any pytree of
    per-unit tensors; returns ``(final, extras)`` with extras' leaves
    stacked ``(L, N, ...)`` in layer order."""
    n = x.shape[0]
    if n % microbatches:
        raise ValueError(f"units {n} not divisible by microbatches {microbatches}")
    layers = _local_layers(stack, mesh)
    n_layers = stack.n_layers if isinstance(stack, PlacedStack) else len(stack)
    aux_flat, aux_spec = pytree.tree_flatten(aux)
    params = [q for layer in layers for q in layer.parameters()]
    run = _Run(layer_fn, layers, mesh, microbatches, collect, aux_spec, len(aux_flat), n_layers)
    res = _Pipeline.apply(run, x, *aux_flat, *params)
    if not collect:
        return res[0]
    return res[0], pytree.tree_unflatten(list(res[1:]), run.extras_spec)


def encoder_stack_params(model: nn.Module) -> nn.ModuleList:
    """The space-text encoder's layers (``transformer.encoder.layers``) as
    the stack ``pipeline_apply`` consumes."""
    return stack_layer_params(model.transformer.encoder.layers)


def pipelined_encoder_apply(stack, x: torch.Tensor, pos: torch.Tensor, key_pad_mask: torch.Tensor,
                            *, mesh: PipeMesh, microbatches: int) -> torch.Tensor:
    """The space-text encoder stack pipelined with clips as the units: ``x``
    and ``pos`` ``(N, S, D)``, ``key_pad_mask`` ``(N, S)`` (True = pad), N =
    B * Tc. Equal to the model's sequential stack (the layers' dropout must
    be off)."""
    def layer_fn(layer, y, aux):
        return layer(y, aux[0], aux[1])[0]

    return pipeline_apply(layer_fn, stack, x, (pos, key_pad_mask), mesh=mesh,
                          microbatches=microbatches)


def decoder_stack_params(model: nn.Module) -> nn.ModuleList:
    """The decoder's layers (the shared final ``norm`` is not a layer:
    apply it to the collected stack, as ``Decoder`` does)."""
    return stack_layer_params(model.transformer.decoder.layers)


def pipelined_decoder_apply(stack, tgt, query_pos, memory, memory_pos, memory_pad_mask,
                            query_pad_mask, *, mesh: PipeMesh, microbatches: int):
    """The space-time decoder stack pipelined with videos as the units:
    ``tgt``/``query_pos`` ``(B, T*nq, D)``, ``memory``/``memory_pos`` ``(B, T,
    S, D)``, the masks ``(B, T, S)`` and ``(B, T*nq)``. Returns ``(hs, tsa_w,
    cross_w)``, every layer's output and attention weights stacked ``(L, B,
    ...)``, pre-norm."""
    def layer_fn(layer, y, aux):
        out, w, cw = layer(y, *aux)
        return out, (out, w, cw)

    _, (hs, tsa, cross) = pipeline_apply(
        layer_fn, stack, tgt, (query_pos, memory, memory_pos, memory_pad_mask, query_pad_mask),
        mesh=mesh, microbatches=microbatches, collect=True)
    return hs, tsa, cross
