"""The training and evaluation CLI (counterpart of ``tubedetr_tpu/apps/train.py``).

    python -m tubedetr_tpu_torch.apps.train --dataset_config config/vidstg.json \\
        --combine_datasets vidstg --combine_datasets_val vidstg --ema --output-dir out

On several cards, one process a card, launched by ``torchrun
--nproc_per_node N -m tubedetr_tpu_torch.apps.train ...`` or ``srun python
-m tubedetr_tpu_torch.apps.train ...`` (``parallel/dist.py`` reads either's
environment; NCCL on the card, gloo with ``--device cpu``). Ranks other
than 0 print only what is forced. The ``(data, time, model)`` mesh spans
every process (``--mesh_time`` of them split a video's frames,
``--mesh_model`` of them hold the slices of the transformer's and
RoBERTa's layers and print the JAX CLI's ``tp: N param leaves over model``
line; the data axis widens to the rest), the data seed is ``seed + data rank`` while the model
and the shuffle read ``seed`` alone, and each data rank's loaders read its
share of the samples. ``--shard_optimizer_state`` (ZeRO-1) and
``--shard_params`` (FSDP) print the JAX package's ``[zero]`` and ``[shard]``
lines. The evaluation runs each data rank's share (a tail batch padded by
repeating its last sample, sliced away before the merge) on weights
replicated over the data axis (a sharded state gathered first; the
tensor-parallel slices stay sliced, ``--eval`` included), then merges the vIoU predictions
and the meters; the int8 scales are the maximum over the ranks. Rank 0
alone writes the checkpoints (one process's format, gathered), ``log.txt``
and ``log_stats.json``.

Config (with the ``--dataset_config`` overlay) -> seeding -> the model built
from ``--seed`` on ``--device`` -> ``--load`` (a ``.pth`` with the warm-start
surgery) -> the train state -> ``--resume`` (parameters, EMA, optimizer
moments and step counts, then the epoch after the saved one) -> the val
loaders (``div_vid`` and their batch size as the reference's) -> ``--eval``
/ ``--test``: one evaluation, ``log_stats.json``. Otherwise the epoch loop:
``--epoch_chunks`` chunks, the feed (``--device_prefetch N``: a side-stream
prefetcher; 0: the same-thread one), ``train_one_epoch``, the checkpoints
(``checkpoint.pth`` every epoch, ``checkpoint{epoch:04}.pth`` every 2
epochs, before ``lr_drop`` or always for vidstg; ``--async_checkpoint``
writes behind training), an evaluation every ``eval_skip`` epochs, and a
``log.txt`` line an epoch with the JAX package's keys.

An int8 backbone (``--backbone_quant int8_static``, with K2 through a
``--dataset_config`` overlay setting ``fused_bottleneck``) runs for
evaluation only: its scales are calibrated on the first val batch (with the
EMA weights under ``--ema``) or read from a sidecar in ``--qscales_dir``.

Quantized training, as the JAX CLI runs it: ``--backbone_quant int8_qat``
(fake-quant with straight-through gradients; its scales are the eval
calibration's, and the checkpoints carry them for an ``int8_static``
deployment), ``--backbone_quant_fast`` (the gradient-free fast pass in int8)
and ``--backbone_quant_frozen`` (the frozen stem and layer1 of the slow
pass in int8): ``int8_static`` calibrates on one train batch unless the
eval calibration or a sidecar serves, dynamic ``int8`` needs no scales. The
scales are the trunk's observer buffers, which every pass, the evaluation
and the checkpoint read. ``--log_quant_drift`` prints each epoch's worst
observed/baked activation-max ratio (one observer forward on a fresh train
batch); ``--recalibrate_each_epoch`` also writes the observed maxima, the
maximum over the ranks, as the new scales.
"""

from __future__ import annotations

import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch


@dataclass
class RunStats:
    """What a caller may read back from ``main``: each train step's loader
    wait and step seconds (host clock; the step ends when the loop reads
    the loss back), each checkpoint save's blocking seconds, the frame
    sizes of the batches, each evaluation's vIoU summary, and the train
    state at the end. With ``profile_step`` that step (counted over the
    run) runs under ``torch.profiler`` with device activities, kept in
    ``profile``."""

    profile_step: Optional[int] = None
    steps: List[Dict] = field(default_factory=list)
    checkpoint_s: List[Dict] = field(default_factory=list)
    frame_hw: List[tuple] = field(default_factory=list)
    evals: List[Dict] = field(default_factory=list)
    profile: object = None
    state: object = None


class TimedFeed:
    """A sized iterable over ``feed`` that records, for each ``(batch,
    meta)``, the seconds the consumer waited for it and the seconds until
    the consumer asked for the next one (its step)."""

    def __init__(self, feed, stats: Optional[RunStats]):
        self.feed, self.stats = feed, stats

    def __len__(self):
        return len(self.feed)

    def __iter__(self):
        if self.stats is None:
            yield from self.feed
            return
        it = iter(self.feed)
        while True:
            t0 = time.perf_counter()
            try:
                batch, meta = next(it)
            except StopIteration:
                return
            wait_s = time.perf_counter() - t0
            self.stats.frame_hw.append(tuple(batch["frames_slow"].shape[2:4]))
            prof = None
            if self.stats.profile_step == len(self.stats.steps):
                from torch.profiler import ProfilerActivity, profile

                prof = profile(activities=[ProfilerActivity.CUDA])
                prof.__enter__()
            t1 = time.perf_counter()
            yield batch, meta
            step_s = time.perf_counter() - t1  # the profiler's start and stop left out
            if prof is not None:
                prof.__exit__(None, None, None)
                self.stats.profile = prof
            self.stats.steps.append({"wait_s": wait_s, "step_s": step_s})


class PaddedTail:
    """The evaluation's batches of ``loader``, each padded to the loader's
    batch size by repeating its last sample (the JAX CLI's
    ``_ShardedEval``); ``meta`` keeps the real length, so ``evaluate``
    slices the padded outputs away."""

    def __init__(self, loader):
        self.loader = loader

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for batch, meta in self.loader:
            b = len(meta["video_ids"])
            extra = self.loader.batch_size - b
            if extra > 0:
                batch = {k: _repeat_last(v, extra) for k, v in batch.items()}
            yield batch, meta


def _repeat_last(v, n: int):
    if torch.is_tensor(v):
        return torch.cat([v, v[-1:].expand(n, *v.shape[1:])])
    return np.concatenate([v, np.repeat(v[-1:], n, axis=0)])


class _SameThreadFeed:
    """``prefetch_to_device`` over a fresh pass of ``loader``, sized."""

    def __init__(self, loader, device):
        self.loader, self.device = loader, device

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        from tubedetr_tpu_torch.data.loader import prefetch_to_device

        return prefetch_to_device(iter(self.loader), self.device, size=2)


def main(argv=None, stats: Optional[RunStats] = None) -> int:
    """Parse ``argv``, join the launcher's process group when there is one
    (left at the end), run."""
    from tubedetr_tpu_torch.apps.cli import config_from_args
    from tubedetr_tpu_torch.parallel import dist as tdist

    cfg = config_from_args(argv)
    if cfg.backbone_quant in ("int8", "int8_static") and not cfg.evaluate_only:
        raise NotImplementedError(
            "--backbone_quant int8/int8_static trains nothing (zero gradients through "
            "round()); use it with --eval, or in the demo and serving paths. To train "
            "quantized use --backbone_quant int8_qat (fake-quant with straight-through "
            "gradients), or quantize only the gradient-free passes with "
            "--backbone_quant_fast/--backbone_quant_frozen int8_static"
        )
    distributed = tdist.init_distributed_mode(cfg.device)
    try:
        return _run(cfg, stats, distributed)
    finally:
        if distributed:
            tdist.restore_print()
            import torch.distributed as dist

            dist.destroy_process_group()


def _run(cfg, stats: Optional[RunStats], distributed: bool) -> int:
    from tubedetr_tpu_torch.data.datasets import build_dataset
    from tubedetr_tpu_torch.data.loader import (
        ConcatDataset,
        DataLoader,
        DevicePrefetcher,
        EpochChunkView,
    )
    from tubedetr_tpu_torch.eval.viou import VIoUEvaluator
    from tubedetr_tpu_torch.models.quantize import (
        get_or_calibrate_qscales,
        make_drift_checker,
        model_qscales,
        recalibrate,
        weights_tag_for,
    )
    from tubedetr_tpu_torch.models.tokenizer import build_tokenizer
    from tubedetr_tpu_torch.models.tubedetr import build_model
    from tubedetr_tpu_torch.parallel import dist as tdist
    from tubedetr_tpu_torch.parallel.mesh import gather_state, make_mesh, mesh_shape
    from tubedetr_tpu_torch.parallel.train_step import (
        TrainState,
        create_train_state,
        ema_weights,
        make_eval_step,
        make_train_step,
        model_inputs,
        parallelize,
        to_device,
    )
    from tubedetr_tpu_torch.train.checkpoint import (
        AsyncCheckpointWriter,
        checkpoint_payload,
        load_checkpoint,
        load_pretrained,
        resume_state,
        save_checkpoint,
    )
    from tubedetr_tpu_torch.train.engine import evaluate, train_one_epoch
    from tubedetr_tpu_torch.utils.device import configure_precision, resolve_device
    from tubedetr_tpu_torch.utils.misc import get_sha

    device = tdist.device_for(resolve_device(cfg.device))
    main_rank = tdist.is_main_process()
    if distributed:
        tdist.setup_print_for_distributed(main_rank)
        print(f"distributed: {tdist.get_world_size()} processes, rank {tdist.get_rank()} on "
              f"{device}", force=True)
    configure_precision(device)
    on_card = device.type == "cuda"
    print(get_sha())
    print(f"config: {cfg}")
    data, time_, model_ = mesh_shape(cfg, tdist.get_world_size())
    mesh = make_mesh(data, time_, device.type, model_)

    # the data seed is the seed plus the data rank; the model, the loaders'
    # shuffle and the epoch chunks (which the data ranks share) read the
    # seed itself
    np.random.seed(cfg.seed + mesh.data_rank)
    torch.manual_seed(cfg.seed)
    tokenizer = build_tokenizer(cfg.tokenizer_path, cfg.text_vocab_size)
    model = build_model(cfg, device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"number of params: {n_params / 1e6:.1f}M")

    if cfg.load:
        missing, _ = load_pretrained(model, cfg.load, rd_init_tsa=cfg.rd_init_tsa)
        if missing:
            print(f"[load] {len(missing)} tensors kept at init (e.g. {missing[:5]})")
    if cfg.evaluate_only:
        # evaluation runs in the compute dtype and steps nothing
        model.cast_compute()
        ema = {n: p.detach().clone() for n, p in model.named_parameters()} if cfg.ema else None
        state = TrainState(model, None, {}, ema)
    else:
        state = create_train_state(cfg, model)
    start_epoch = 0
    if cfg.resume:
        start_epoch = resume_state(state, load_checkpoint(cfg.resume))
    if cfg.evaluate_only:  # the time group splits the frames
        model.time_group = mesh.time_group if mesh.time > 1 else None
        if mesh.model > 1:  # the evaluation runs on the tensor-parallel slices
            from tubedetr_tpu_torch.parallel.tp import count_tp_sharded, shard_tp
            from tubedetr_tpu_torch.parallel.train_step import sync_from_rank0

            n = count_tp_sharded(model, mesh.model, cfg.nheads, cfg.text_heads)
            sync_from_rank0(state)
            shard_tp(cfg, state, mesh)
            print(f"[shard] tp: {n} param leaves over model ({mesh.model}-way)")
    else:  # a one-process state (resumed) resharded over the mesh
        state = parallelize(cfg, state, mesh)

    out_dir = Path(cfg.output_dir) if cfg.output_dir else None
    if out_dir:
        out_dir.mkdir(parents=True, exist_ok=True)
    ckpt_writer = AsyncCheckpointWriter() if cfg.async_checkpoint and main_rank else None

    def loader_for(dataset, **kw):
        return DataLoader(dataset, stride=cfg.stride, max_text_len=cfg.max_text_len, seed=cfg.seed,
                          num_workers=cfg.num_workers, with_fast=cfg.fast, tokenizer=tokenizer,
                          frames_dtype=cfg.frames_dtype, compact_pad_masks=cfg.compact_pad_masks,
                          pin_memory=on_card, process_index=mesh.data_rank,
                          process_count=mesh.data, **kw)

    def make_val_loaders():
        loaders = []
        for name in cfg.combine_datasets_val:
            ds = build_dataset(name, "test" if cfg.test else "val", cfg, tokenizer)
            div = cfg.video_max_len_train if cfg.video_max_len_train != cfg.video_max_len else 0
            bs = math.ceil(cfg.batch_size * cfg.video_max_len_train / cfg.video_max_len)
            loaders.append((name, ds, loader_for(ds, batch_size=max(bs, 1),
                                                 t=div or cfg.video_max_len, div_vid=div)))
        return loaders

    def feed(loader):
        if cfg.device_prefetch > 0:
            return DevicePrefetcher(loader, size=cfg.device_prefetch, device=device)
        return _SameThreadFeed(loader, device)

    if cfg.backbone_quant != "none":
        # PTQ: one observer forward on the first val batch (the EMA weights
        # under --ema), or the sidecar of this config, weights and data
        calib_batch, _ = next(iter(make_val_loaders()[0][2]))
        inputs = model_inputs(to_device(calib_batch, device))
        with ema_weights(state):  # the raw weights when the state has no EMA
            _, source = get_or_calibrate_qscales(
                cfg, model, inputs, cache_dir=cfg.qscales_dir, force=cfg.calibrate,
                weights_tag=weights_tag_for(cfg, default=f"init-torch-seed{cfg.seed}"),
                data_tag="val:" + ",".join(cfg.combine_datasets_val),
            )
        del calib_batch, inputs
        print(f"[quant] {cfg.backbone_quant} scales "
              + ("loaded from sidecar cache" if source == "cache"
                 else f"calibrated ({cfg.combine_datasets_val[0]} val batch)"))
    eval_step = make_eval_step(cfg, ema=cfg.ema)

    def run_eval():
        all_stats = {}
        eval_state = gather_state(state)  # replicated weights and EMA
        for name, ds, loader in make_val_loaders():
            ev = VIoUEvaluator(ds.annotations, tmp_loc=cfg.tmp_loc, save_pred=cfg.test)
            evaluate(cfg, eval_step, eval_state, feed(PaddedTail(loader) if mesh.distributed
                                                      else loader), ev, name, test_mode=cfg.test)
            ev.synchronize_between_processes(str((out_dir or Path(".")) / "eval_sync"))
            res = ev.summarize()
            if res:
                numeric = {k: v for k, v in res.items() if isinstance(v, (int, float))}
                all_stats.update({f"{name}_{k}": v for k, v in numeric.items()})
                print(f"[{name}] " + json.dumps({k: round(v, 4) for k, v in numeric.items()}))
        if stats is not None:
            stats.evals.append(all_stats)
        return all_stats

    if cfg.evaluate_only:
        test_stats = run_eval()
        if out_dir and main_rank:
            with open(out_dir / "log_stats.json", "w") as f:
                json.dump(test_stats, f)
        if stats is not None:
            stats.state = state
        return 0

    train_sets = [build_dataset(name, "train", cfg, tokenizer) for name in cfg.combine_datasets]
    if not train_sets:
        print("no training datasets specified (--combine_datasets)")
        return 1
    train_base = ConcatDataset(train_sets)

    def make_train_loader(dataset):
        return loader_for(dataset, batch_size=cfg.batch_size, t=cfg.video_max_len_train,
                          shuffle=True, drop_last=True)

    steps_per_epoch = len(make_train_loader(train_base))
    num_training_steps = steps_per_epoch * cfg.epochs

    def train_inputs():
        """The model inputs of the first batch of a fresh train loader."""
        batch, _ = next(iter(make_train_loader(train_base)))
        return model_inputs(to_device(batch, device))

    quant_train = (cfg.backbone_quant_fast != "none" or cfg.backbone_quant_frozen != "none"
                   or cfg.backbone_quant == "int8_qat")
    if quant_train and cfg.backbone_quant != "none":
        # one observer tree serves every pass: the eval calibration's
        print("[quant] training scales reuse the eval calibration")
    elif quant_train and "int8_static" in (cfg.backbone_quant_fast, cfg.backbone_quant_frozen):
        _, source = get_or_calibrate_qscales(
            cfg, model, train_inputs(), cache_dir=cfg.qscales_dir, force=cfg.calibrate,
            weights_tag=weights_tag_for(cfg, default=f"init-torch-seed{cfg.seed}"),
            data_tag="train:" + ",".join(cfg.combine_datasets),
        )
        print(f"[quant] backbone_quant_fast/frozen scales {source} (one train batch)")
    # dynamic int8 passes compute their scales a forward: the zeros stand
    drift_checker = (make_drift_checker(cfg)
                     if quant_train and (cfg.log_quant_drift or cfg.recalibrate_each_epoch)
                     else None)
    train_step = make_train_step(cfg)
    writer = None
    if cfg.tb_dir and main_rank:
        from torch.utils.tensorboard import SummaryWriter

        writer = SummaryWriter(cfg.tb_dir)

    def save(path: Path, payload: Dict):
        if not main_rank:
            return
        t0 = time.perf_counter()
        if ckpt_writer is not None:
            ckpt_writer.save(str(path), payload)
        else:
            save_checkpoint(str(path), payload)
        if stats is not None:
            stats.checkpoint_s.append({"path": path.name, "async": ckpt_writer is not None,
                                       "blocking_s": time.perf_counter() - t0})

    try:
        for epoch in range(start_epoch, cfg.epochs):
            chunks = [train_base] if cfg.epoch_chunks <= 0 else [
                EpochChunkView(train_base, cfg.epoch_chunks, c, seed=cfg.seed + epoch)
                for c in range(cfg.epoch_chunks)
            ]
            for chunk in chunks:
                loader = make_train_loader(chunk)
                loader.set_epoch(epoch)
                # the step count a step reads is epoch * len(this chunk's loader) + i,
                # as the JAX package counts it
                state, train_stats = train_one_epoch(cfg, train_step, state,
                                                     TimedFeed(feed(loader), stats), epoch,
                                                     num_training_steps, writer)
            if drift_checker is not None:
                # one observer forward on a fresh train batch: how far the
                # activations have moved past the baked scales
                ratio, leaf, observed = drift_checker(model, train_inputs())
                print(f"[quant] epoch {epoch} activation drift: worst observed/baked = "
                      f"{ratio:.3f} at {leaf}" + (" (baked scale now clips)" if ratio > 1.0 else ""))
                if cfg.recalibrate_each_epoch:
                    # every pass, the evaluation and the checkpoint read the observers
                    recalibrate(cfg, model, observed)
                    print(f"[quant] epoch {epoch} scales recalibrated")
            if out_dir:  # every rank gathers a sharded state; rank 0 writes
                # the inference scales travel with the weights, so a reload
                # serves int8 without an observer pass
                payload = checkpoint_payload(state, epoch, cfg, qscales=(
                    model_qscales(model) if cfg.backbone_quant != "none" else None))
                save(out_dir / "checkpoint.pth", payload)
                if ((epoch + 1) % 2 == 0 or epoch + 1 == cfg.lr_drop
                        or "vidstg" in cfg.combine_datasets):
                    save(out_dir / f"checkpoint{epoch:04}.pth", payload)
                del payload
            test_stats = run_eval() if epoch % cfg.eval_skip == cfg.eval_skip - 1 else {}
            log_stats = {
                **{f"train_{k}": v for k, v in train_stats.items()},
                **{f"test_{k}": v for k, v in test_stats.items()},
                "epoch": epoch,
                "n_parameters": int(n_params),
            }
            if out_dir and main_rank:
                with open(out_dir / "log.txt", "a") as f:
                    f.write(json.dumps(log_stats) + "\n")
    finally:
        if ckpt_writer is not None:
            ckpt_writer.wait()  # join the write in flight; re-raise its error
        if writer is not None:
            writer.close()
    if stats is not None:
        stats.state = state
    return 0


if __name__ == "__main__":
    sys.exit(main())
