"""The training and evaluation steps (counterpart of ``tubedetr_tpu/parallel/train_step.py``).

A training step: the forward with the training backbone semantics
(``TubeDETR.forward(train=True)``) and the losses, the backward,
``--grad_accum`` equal microbatches (each backward adds into ``.grad``; the
box losses share the whole batch's ``num_boxes`` and the batch-mean losses
are scaled by ``1 / grad_accum``, so the sum equals the big batch's step),
the clip at ``clip_max_norm`` over the parameters that have a gradient, the
optimizer at the step's per-group LRs, and the EMA. Dropout is on unless
the step is ``deterministic``, and draws from a generator seeded from the
dropout seed and the step number. ``TrainStep``'s three phases are public so
that a caller can time them apart. The quantized training passes
(``int8_qat``, ``backbone_quant_fast``, ``backbone_quant_frozen``) read
their scales from the trunk's observer buffers, which calibration and
``models/quantize.py:recalibrate`` write (the maximum over the ranks).

Across processes (``parallelize``, over a ``parallel/mesh.py`` mesh): the
model axis (``mesh_model``, ``parallel/tp.py``) cuts the transformer's and
RoBERTa's weights into slices first; the data axis is DDP over the replica
group (every rank of this rank's model index: all of them when
``mesh_model = 1``) with the frozen stem and layer1 left out (they have no
gradient); ``grad_accum`` holds the all-reduce back until the
last microbatch (``no_sync``); ``num_boxes`` is the data ranks' sum, and a
rank's box losses are scaled by the data size, so DDP's mean over ranks is
the global batch's loss; the metrics are averaged over the data ranks, so
every rank logs, and stops on, the global batch's loss. ZeRO-1
(``shard_optimizer_state``) steps the parameters a rank owns and broadcasts
them; FSDP (``shard_params``, ``parallel/tp.py``) shards the transformer
and the text encoder, and the trunk's gradients (FSDP leaves the trunk
whole) are all-reduced by hand over the replica group. The clip reads the
norm of the whole gradient (a tensor-parallel slice's squares summed over
the model group), and the EMA updates each rank's share. ``mesh_time > 1`` splits
the trunk's frames over the time group (``core/sharding.py``); the dropout
generator takes the data rank into its seed, never the time or the model
rank, so the ranks of a time group or a model group draw the same masks.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from tubedetr_tpu_torch.config import TubeDETRConfig
from tubedetr_tpu_torch.core.masking import inter_positive_map
from tubedetr_tpu_torch.data import collate
from tubedetr_tpu_torch.losses.criterion import SetCriterion
from tubedetr_tpu_torch.models.layers import dropout_generator
from tubedetr_tpu_torch.train.optim import build_optimizer, clip_grad_norm, ema_update, set_lrs
from tubedetr_tpu_torch.utils.device import configure_precision

TARGETS = ("target_boxes", "inter_idx", "time_mask")


@dataclass
class TrainState:
    """The model (its parameters are the state), its optimizer, the labels
    of its parameters, the EMA parameters (or None) and the step count."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    labels: Dict[str, str]
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    step: int = 0
    parallel: Optional["Parallel"] = None

    def trainable(self):
        return [p for p in self.model.parameters() if p.requires_grad]

    @property
    def data_size(self) -> int:
        return self.parallel.mesh.data if self.parallel is not None else 1


@dataclass
class Parallel:
    """How a state spans processes: its mesh and the wrapper of its data
    axis: ``ddp`` (a ``DistributedDataParallel`` over the replica group)
    with, under ZeRO-1, the ``zero`` partition; or ``fsdp``. ``plain`` caches
    the unsharded model that evaluates an FSDP state. The tensor-parallel
    layout lives on the model (``model.tp_layout``)."""

    mesh: object
    ddp: Optional[nn.Module] = None
    zero: Optional[object] = None
    fsdp: bool = False
    plain: Optional[nn.Module] = None

    def runner(self, model: nn.Module) -> nn.Module:
        """The module a train forward goes through."""
        return self.ddp if self.ddp is not None else model

    @contextlib.contextmanager
    def grad_sync(self, model: nn.Module, on: bool):
        """Inside, a backward all-reduces (DDP) or reduce-scatters (FSDP) its
        gradients only when ``on`` (the last microbatch)."""
        if on:
            yield
        elif self.ddp is not None:
            with self.ddp.no_sync():
                yield
        else:
            model.set_requires_gradient_sync(False)
            try:
                yield
            finally:
                model.set_requires_gradient_sync(True)

    def after_backward(self, model: nn.Module) -> None:
        """FSDP leaves the trunk whole: its gradients are averaged over
        the replica group here, as DDP would (``gather_frames`` scaled the
        time ranks' shares)."""
        if not self.fsdp:
            return
        import torch.distributed as dist
        from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

        grads = [p.grad for p in model.backbone.parameters() if p.grad is not None]
        if grads:
            flat = _flatten_dense_tensors(grads)
            group = self.mesh.replica_group
            dist.all_reduce(flat, group=group)
            flat /= dist.get_world_size(group)
            for g, t in zip(grads, _unflatten_dense_tensors(flat, grads)):
                g.copy_(t)

    def after_step(self, state: "TrainState") -> None:
        """ZeRO-1: every parameter from its owner."""
        if self.zero is not None:
            params = dict(state.model.named_parameters())
            self.zero.gather({n: params[n] for n in self.zero.owned()},
                             {n: p.data for n, p in params.items()},
                             into={n: p.data for n, p in params.items()})

    def sum_over_data(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        x = x.clone()
        dist.all_reduce(x, group=self.mesh.data_group)
        return x

    def mean_over_data(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Each metric's mean over the data ranks (one all-reduce)."""
        keys = sorted(metrics)
        flat = self.sum_over_data(torch.stack([metrics[k].detach().float().reshape(()) for k in keys]))
        flat = flat / self.mesh.data
        return {k: flat[i] for i, k in enumerate(keys)}


def create_train_state(cfg: TubeDETRConfig, model: nn.Module) -> TrainState:
    """The state that trains ``model``; on the card, float32 without TF32."""
    cfg.validate_training()
    configure_precision(next(model.parameters()).device)
    optimizer, labels = build_optimizer(cfg, model)
    ema = ({n: p.detach().clone() for n, p in model.named_parameters()} if cfg.ema else None)
    return TrainState(model, optimizer, labels, ema)


def expand_pad_masks(valid_hw: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, T, 2) valid extents -> (B, T, h, w) bool pad mask, True = pad
    (what ``collate`` builds densely without ``compact_pad_masks``)."""
    ih = torch.arange(h, device=valid_hw.device)[:, None]
    iw = torch.arange(w, device=valid_hw.device)[None, :]
    vh = valid_hw[..., 0][..., None, None]
    vw = valid_hw[..., 1][..., None, None]
    return ~((ih < vh) & (iw < vw))


def model_inputs(batch: Dict) -> Dict:
    """``TubeDETR.forward``'s keyword arguments from a batch, the dense pad
    masks rebuilt from ``{fast,slow}_valid_hw`` where the batch has those."""
    out = collate.model_inputs(batch)
    for stream in ("slow", "fast"):
        if f"{stream}_valid_hw" in batch and f"{stream}_pad_mask" not in out:
            frames = out[f"frames_{stream}"]
            out[f"{stream}_pad_mask"] = expand_pad_masks(
                batch[f"{stream}_valid_hw"], frames.shape[2], frames.shape[3]
            )
    return out


def to_device(batch: Dict, device: torch.device) -> Dict:
    """Every numpy array and tensor of ``batch`` as a tensor on ``device``."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(v)
        out[k] = v.to(device) if torch.is_tensor(v) else v
    return out


def dropout_seed_for(seed: int, step: int, data_rank: int = 0) -> int:
    """The dropout generator's seed at ``step``, as JAX folds the step into
    the seed's key (``fold_in``): both mixed into 32 bits, the part of a
    seed that the CPU generator reads. A data rank other than 0 is mixed in
    too (each draws its own masks); a time rank never is."""
    words = [int(seed), int(step)] + ([int(data_rank)] if data_rank else [])
    return int(np.random.SeedSequence(words).generate_state(1)[0])


class TrainStep:
    """``step(state, batch, lrs, dropout_seed) -> (state, metrics)``.
    ``metrics`` holds each loss term (summed over the microbatches),
    ``loss_total`` and ``grad_norm``, the norm before the clip."""

    def __init__(self, cfg: TubeDETRConfig, deterministic: bool = False):
        self.cfg = cfg
        self.criterion = SetCriterion(cfg)
        self.deterministic = deterministic

    def forward_loss(self, state: TrainState, batch: Dict, num_boxes=None, mean_scale: float = 1.0):
        """(total, losses) of one (micro)batch already on the model's device."""
        model = state.model if state.parallel is None else state.parallel.runner(state.model)
        outputs = model(**model_inputs(batch), train=True)
        losses = self.criterion(outputs, *(batch[k] for k in TARGETS), num_boxes=num_boxes,
                                mean_scale=mean_scale, sum_scale=state.data_size)
        return self.criterion.total(losses), losses

    def backward(self, total: torch.Tensor) -> None:
        total.backward()

    def update(self, state: TrainState, lrs: Dict[str, float]) -> torch.Tensor:
        """Clip, the optimizer step and the EMA; returns the pre-clip norm."""
        from tubedetr_tpu_torch.parallel.tp import tp_layout_of

        par, layout = state.parallel, tp_layout_of(state.model)
        named = [(n, p) for n, p in state.model.named_parameters() if p.requires_grad]
        params = [p for _, p in named]
        norm = clip_grad_norm(
            params, self.cfg.clip_max_norm,
            par.mesh.data_group if par is not None and par.fsdp else None,
            None if layout is None else [n in layout.splits for n, _ in named],
            None if layout is None else layout.group)
        set_lrs(state.optimizer, lrs)
        state.optimizer.step()
        if par is not None:
            par.after_step(state)
        if state.ema_params is not None:
            ema_update(state.ema_params, dict(state.model.named_parameters()), self.cfg.ema_decay)
        # int8 weights cached from the old float weights must not outlive them
        state.model.backbone[0].body.clear_int8_cache()
        state.step += 1
        return norm

    def generator(self, state: TrainState, dropout_seed: int, device) -> torch.Generator:
        gen = torch.Generator(device=device)
        data_rank = state.parallel.mesh.data_rank if state.parallel is not None else 0
        gen.manual_seed(dropout_seed_for(dropout_seed, state.step, data_rank))
        return gen

    def __call__(self, state: TrainState, batch: Dict, lrs: Dict[str, float], dropout_seed: int):
        model, par = state.model, state.parallel
        device = next(model.parameters()).device
        batch = to_device(batch, device)
        (model if par is None else par.runner(model)).train(not self.deterministic)
        state.optimizer.zero_grad(set_to_none=True)
        accum = max(int(self.cfg.grad_accum), 1)
        num_boxes = None
        if accum > 1 or state.data_size > 1:
            t = batch["time_mask"].shape[1]
            num_boxes = (inter_positive_map(batch["inter_idx"], t) & batch["time_mask"]).sum().float()
            if state.data_size > 1:
                num_boxes = par.sum_over_data(num_boxes)
        n = batch["time_mask"].shape[0] // accum
        total, losses = 0.0, {}
        with dropout_generator(self.generator(state, dropout_seed, device)):
            for i in range(accum):
                micro = batch if accum == 1 else {k: v[i * n:(i + 1) * n] if torch.is_tensor(v) else v
                                                  for k, v in batch.items()}
                with (par.grad_sync(model, i == accum - 1) if par is not None
                      else contextlib.nullcontext()):
                    mt, ml = self.forward_loss(state, micro, num_boxes, 1.0 / accum)
                    self.backward(mt)
                total = total + mt.detach()
                for k, v in ml.items():
                    losses[k] = losses.get(k, 0.0) + v.detach()
        if par is not None:
            par.after_backward(model)
        norm = self.update(state, lrs)
        model.eval()
        metrics = dict(losses)
        metrics["loss_total"] = total
        if par is not None and state.data_size > 1:
            metrics = par.mean_over_data(metrics)
        metrics["grad_norm"] = norm
        return state, metrics


def make_train_step(cfg: TubeDETRConfig, deterministic: bool = False) -> TrainStep:
    """``deterministic`` turns dropout off (the parity tests' dropout-free
    step); training keeps it on."""
    return TrainStep(cfg, deterministic)


EVAL_KEYS = ("pred_boxes", "pred_sted", "weights", "ca_weights")
QUERY_KEYS = ("pred_boxes_queries", "pred_sted_queries", "pred_obj_queries")


@contextlib.contextmanager
def ema_weights(state: TrainState):
    """Inside, the model's parameters hold the EMA weights (each tensor's
    ``.data`` swapped, nothing copied; buffers named in ``ema_params`` too);
    a state without EMA leaves them as they are. Caches made from weights
    (the int8 weights and K2's folds) key on the tensor they were made
    from, so neither the EMA's nor the raw weights' cache serves the other."""
    if state.ema_params is None:
        yield
        return
    live = {**dict(state.model.named_buffers()), **dict(state.model.named_parameters())}
    saved = {n: live[n].data for n in state.ema_params}
    try:
        for n, t in state.ema_params.items():
            live[n].data = t
        yield
    finally:
        for n, t in saved.items():
            live[n].data = t


def make_eval_step(cfg: TubeDETRConfig, ema: bool = False):
    """``step(state, batch) -> (outputs, losses)``: the inference forward
    (``train=False``, dropout off), with the EMA parameters when ``ema`` and
    the state has them, and the losses when the batch has targets. The
    outputs are ``EVAL_KEYS``, plus the per-query heads that the query
    selectors of ``nq_select`` read."""
    criterion = SetCriterion(cfg)
    keep = EVAL_KEYS + (QUERY_KEYS if cfg.num_queries > 1 and cfg.nq_select in ("sted", "objectness")
                        else ())

    @torch.no_grad()
    def step_fn(state: TrainState, batch: Dict):
        model = state.model
        batch = to_device(batch, next(model.parameters()).device)
        model.eval()
        inputs = model_inputs(batch)
        with ema_weights(state) if ema else contextlib.nullcontext():
            outputs = model(**inputs)
        losses = {}
        if "target_boxes" in batch:
            losses = criterion(outputs, *(batch[k] for k in TARGETS))
        return {k: outputs[k] for k in keep if k in outputs}, losses

    return step_fn


@torch.no_grad()
def sync_from_rank0(state: TrainState) -> None:
    """Rank 0's parameters, buffers and EMA on every rank of the world group
    (one broadcast a dtype): replicas built from one seed are equal already,
    but FSDP and tensor parallelism cut what each rank holds (they run after
    this, on whole tensors) and DDP broadcasts neither the EMA nor a buffer
    it is told to leave."""
    import torch.distributed as dist
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    tensors = [t.data for t in state.model.parameters()] + list(state.model.buffers())
    if state.ema_params is not None:
        tensors += list(state.ema_params.values())
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        group = [t for t in tensors if t.dtype == dtype]
        flat = _flatten_dense_tensors(group)
        dist.broadcast(flat, src=0, group=dist.group.WORLD)
        for t, v in zip(group, _unflatten_dense_tensors(flat, group)):
            t.copy_(v)


def parallelize(cfg: TubeDETRConfig, state: TrainState, mesh, tp: Optional[bool] = None) -> TrainState:
    """``state`` spread over ``mesh`` (a ``parallel/mesh.py:Mesh``), in
    place: the model's trunk splits its frames over the time group; the
    model axis cuts the split weights (``tp``: None engages it when
    ``mesh.model > 1``, True on any mesh, a one-rank model group included);
    the data axis is FSDP (``shard_params``) or DDP over the replica group,
    with ZeRO-1 under ``shard_optimizer_state``. Each prints the JAX CLI's
    line. Call it after ``--resume`` loaded the one-process state: it
    reshards that. Rank 0's weights and EMA go to every rank first
    (``sync_from_rank0``). A one-process mesh leaves ``state`` as it is."""
    if not mesh.distributed:
        return state
    model = state.model
    model.time_group = mesh.time_group if mesh.time > 1 else None
    sync_from_rank0(state)
    par = Parallel(mesh)
    if tp or (tp is None and mesh.model > 1):
        from tubedetr_tpu_torch.parallel.tp import count_tp_sharded, shard_tp

        n = count_tp_sharded(model, mesh.model, cfg.nheads, cfg.text_heads)
        shard_tp(cfg, state, mesh)
        print(f"[shard] tp: {n} param leaves over model ({mesh.model}-way)")
    if cfg.shard_params:
        from tubedetr_tpu_torch.parallel.tp import shard_train_state

        shard_train_state(cfg, state, mesh)
        par.fsdp = True
        print(f"[shard] fsdp: params + state over data ({mesh.data}-way)")
    else:
        from torch.nn.parallel import DistributedDataParallel

        if cfg.shard_optimizer_state:
            from tubedetr_tpu_torch.parallel.mesh import shard_opt_state_along_data

            par.zero = shard_opt_state_along_data(cfg, state, mesh)
            print(f"[zero] optimizer state + EMA sharded over data axis ({mesh.data}-way)")
        device = next(model.parameters()).device
        # every trainable parameter gets a gradient in every variant: no
        # find_unused_parameters; the buffers are equal on every rank:
        # sync_from_rank0 made them so, FrozenBN statistics never change,
        # and the int8 maxima are written max-reduced (quantize.recalibrate)
        par.ddp = DistributedDataParallel(
            model, device_ids=[device.index] if device.type == "cuda" else None,
            broadcast_buffers=False, process_group=mesh.replica_group)
    state.parallel = par
    return state
