"""Rank bodies for ``tests/test_torch_dist.py``: spawned gloo processes on the CPU.

``spawn(fn, world, tmp, *args)`` starts ``world`` processes with the
``spawn`` method; each joins a gloo process group through a file in
``tmp`` (no fixed port: the tests run under xdist), calls ``fn(rank,
world, *args)`` and sends back its result. A rank that raises sends its
traceback; the parent then kills the others (they would wait forever in a
collective), and every process is joined with a deadline. This module
imports no JAX: the children import only it and the port.
"""

from __future__ import annotations

import os
import pickle
import queue
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

KW = dict(
    backbone="resnet14", hidden_dim=32, nheads=4, enc_layers=1, dec_layers=1, dim_feedforward=64,
    video_max_len=8, video_max_len_train=8, stride=2, resolution=128, max_text_len=8,
    text_vocab_size=128, text_hidden_size=32, text_layers=1, text_heads=4, text_ffn=64,
    text_max_positions=40, guided_attn=True, sted=True, aux_loss=True, dropout=0.0,
    ema=True, ema_decay=0.9, clip_max_norm=0.1, weight_decay=1e-4,
    lr=1e-3, lr_backbone=1e-4, text_encoder_lr=1e-3, batch_size=2, device="cpu",
)
LRS = {"lr": 1e-3, "lr_backbone": 1e-4, "lr_text_encoder": 1e-3}
T, STRIDE = 8, 2
# four videos: seeds and durations (a dur % stride tail); the first two
# (rank 0's half) hold more annotated frames than the last two
VIDEOS = ((0, 8), (1, 7), (2, 8), (3, 6))
THREADS = 1  # a rank's CPU threads (a float sum's order follows their count)
LOSS_RTOL, PARAM_ATOL = 1e-5, 2e-5
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-5
GROUP_LR = {"main": LRS["lr"], "backbone": LRS["lr_backbone"], "text": LRS["lr_text_encoder"]}


def _entry(rank, world, init, fn, args, results, device, threads):
    torch.set_num_threads(threads)
    import torch.distributed as dist

    from tubedetr_tpu_torch.parallel.dist import init_process_group

    try:
        # gloo on the CPU; NCCL on the card, rank r on cuda:r
        init_process_group(torch.device(device), rank, world, f"file://{init}", local_rank=rank)
        # pickled here: a tensor put on the queue as it is would travel as a
        # shared-memory handle, gone once this process exits
        results.put((rank, True, pickle.dumps(fn(rank, world, *args))))
    except BaseException:  # noqa: BLE001 - the parent re-raises it with the rank
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world: int, tmp, *args, timeout: float = 240.0, device: str = "cpu",
          threads: int = THREADS) -> list:
    """Each rank's ``fn(rank, world, *args)``, in rank order; raises with
    the first failing rank's traceback. ``device="cuda"``: NCCL, a card a
    rank. ``threads``: a rank's CPU threads (``THREADS`` where a result is
    held bit for bit to one process)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init = os.path.join(str(tmp), f"pg-{fn.__name__}")  # a file store must start absent
    if os.path.exists(init):
        os.remove(init)
    procs = [ctx.Process(target=_entry, args=(r, world, init, fn, args, results, device, threads),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    out, error = {}, None
    try:
        while len(out) < world and error is None:
            try:
                rank, ok, res = results.get(timeout=timeout)
            except queue.Empty:
                error = f"no result within {timeout} s from ranks {sorted(set(range(world)) - set(out))}"
                break
            if ok:
                out[rank] = pickle.loads(res)
            else:
                error = f"rank {rank} failed:\n{res}"
    finally:
        for p in procs:
            p.join(timeout=5 if error is None else 0.1)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
    if error is not None:
        raise AssertionError(error)
    assert not any(p.is_alive() for p in procs)
    return [out[r] for r in range(world)]


# ---------------------------------------------------------------------------
# the bounds a multi-rank step is held to
# ---------------------------------------------------------------------------


def labels_of(cfg):
    from tubedetr_tpu_torch.models.tubedetr import build_model
    from tubedetr_tpu_torch.train.optim import label_params

    return label_params(build_model(cfg, device="cpu"))


def adamw_atol(labels, grads, ref_grads, grad_norm, max_norm):
    """{name: per-element atol} of post-step parameters after AdamW's first
    step: ``PARAM_ATOL`` plus ``lr * |u(g) - u(g_ref)|`` of the clipped
    gradients, ``u(g) = g / (|g| + 1e-8)``. Checks that the second term
    exceeds ``PARAM_ATOL`` on under 1% of the elements."""
    scale = min(1.0, max_norm / grad_norm)

    def u(g):
        g = g * scale
        return g / (np.abs(g) + 1e-8)

    atol, loose, total = {}, 0, 0
    for n, g in grads.items():
        extra = GROUP_LR[labels[n]] * np.abs(u(g) - u(ref_grads[n]))
        atol[n] = PARAM_ATOL + extra
        loose += int((extra > PARAM_ATOL).sum())
        total += g.size
    assert loose < 0.01 * total, (loose, total)
    return atol


def assert_close(ours, ref, atol, what):
    for n, tol in atol.items():
        diff = np.abs(ours[n] - ref[n])
        assert (diff <= tol).all(), f"{what} {n}: max |diff| {diff.max()}, over by {(diff - tol).max()}"


def assert_step_matches(res, ref, labels, step=0):
    """A multi-rank step's results against one process's: the loss terms,
    ``grad_norm``, the gradients, the parameters and the EMA."""
    m, rm = res["metrics"][step], ref["metrics"][step]
    assert set(m) == set(rm)
    for k in rm:
        np.testing.assert_allclose(m[k], rm[k], rtol=LOSS_RTOL, err_msg=k)
    for n, g in ref["grads"].items():
        np.testing.assert_allclose(res["grads"][n], g, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=f"grad {n}")
    assert set(res["grads"]) == set(ref["grads"])
    atol = adamw_atol(labels, res["grads"], ref["grads"], rm["grad_norm"], KW["clip_max_norm"])
    trainable = set(atol)
    atol.update({n: np.float32(0.0) for n in ref["params"] if n not in trainable})  # frozen
    assert_close(res["params"], ref["params"], atol, "param")
    assert_close(res["ema"], ref["ema"], atol, "ema")


# ---------------------------------------------------------------------------
# the model, the batches, the steps
# ---------------------------------------------------------------------------


def cfg_of(**extra):
    from tubedetr_tpu_torch.config import TubeDETRConfig

    return TubeDETRConfig(**{**KW, **extra})


def samples(videos=VIDEOS):
    from tubedetr_tpu_torch.data.synthetic import make_synthetic_sample

    return [make_synthetic_sample(s, t=d, vocab=KW["text_vocab_size"]) for s, d in videos]


def batch_of(videos=VIDEOS):
    from tubedetr_tpu_torch.data.collate import collate

    return collate(samples(videos), T, STRIDE, KW["max_text_len"])


def model_from(weights_path: str, cfg, device="cpu"):
    from tubedetr_tpu_torch.models.tubedetr import build_model

    model = build_model(cfg, device=device)
    model.load_state_dict(torch.load(weights_path))
    return model


def numpy_dict(d):
    return {k: v.detach().float().cpu().numpy().copy() for k, v in d.items()}


class RecordingStep:
    """The dropout-free train step that keeps the pre-clip gradients,
    whole (an FSDP shard's and a tensor-parallel slice's gathered: a
    collective on every rank)."""

    def __init__(self, cfg):
        from tubedetr_tpu_torch.parallel.tp import full, gather_named, tp_layout_of
        from tubedetr_tpu_torch.parallel.train_step import TrainStep

        outer = self

        class Step(TrainStep):
            def update(self, state, lrs):
                grads = {n: full(p.grad).detach().clone() for n, p in
                         state.model.named_parameters() if p.grad is not None}
                # a tensor-parallel slice's gradient put back whole (a collective)
                outer.grads = gather_named(grads, tp_layout_of(state.model))
                return super().update(state, lrs)

        self.step = Step(cfg, deterministic=True)
        self.grads = None

    def __call__(self, state, batch, lrs=LRS, seed=0):
        return self.step(state, batch, lrs, seed)


def run_steps(cfg, weights_path, batch, mesh=None, n_steps=1, resume=None, device="cpu", tp=None):
    """One train state from the saved weights (resumed from the checkpoint
    ``resume`` when given), spread over ``mesh``, ``n_steps`` dropout-free
    steps on ``batch``. Returns a dict of numpy results: each step's
    metrics, the last step's pre-clip gradients, the whole parameters, EMA
    and optimizer moments after the steps, and what this rank holds of
    the moments and the EMA."""
    from tubedetr_tpu_torch.parallel.mesh import full_state_dicts
    from tubedetr_tpu_torch.parallel.tp import is_sharded
    from tubedetr_tpu_torch.parallel.train_step import create_train_state, parallelize
    from tubedetr_tpu_torch.train.checkpoint import load_checkpoint, resume_state, snapshot
    from tubedetr_tpu_torch.train.optim import _local

    state = create_train_state(cfg, model_from(weights_path, cfg, device))
    if resume:
        resume_state(state, load_checkpoint(resume))
    if mesh is not None:
        state = parallelize(cfg, state, mesh, tp=tp)
    step = RecordingStep(cfg)
    metrics = []
    for _ in range(n_steps):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    model_sd, ema, opt_sd = full_state_dicts(state)
    params = {n: model_sd[n] for n, _ in state.model.named_parameters()}
    local_moments = sum(_local(v).numel() for st in state.optimizer.state.values()
                        for k, v in st.items() if k in ("exp_avg", "exp_avg_sq"))
    layout = getattr(state.model, "tp_layout", None)
    return {
        "metrics": metrics,
        "grads": numpy_dict(step.grads),
        "tp_split": sorted(layout.splits) if layout is not None else [],
        "params": numpy_dict(params),
        "ema": numpy_dict(ema),
        "opt": snapshot(opt_sd),
        "local_moment_elems": int(local_moments),
        "local_ema_elems": int(sum(_local(t).numel() for t in state.ema_params.values())),
        "sharded": sorted(n for n, p in state.model.named_parameters() if is_sharded(p)),
        "state": state,
    }


def _strip(res):
    res = dict(res)
    res.pop("state")
    return res


def data_axis_ranks(rank, world, weights, tmp):
    """The data axis on ``world`` ranks, each on its half of the four
    videos: DDP; DDP with ``grad_accum=2``; ZeRO-1 with the EMA (and its
    checkpoint, written by rank 0); FSDP (and its checkpoint); and the
    one-process checkpoint ``tmp/ckpt1.pth`` resumed under ZeRO-1 and
    under FSDP (one more step each); then ``eval_ranks``."""
    from tubedetr_tpu_torch.parallel.mesh import make_mesh
    from tubedetr_tpu_torch.train.checkpoint import checkpoint_payload, save_checkpoint

    mesh = make_mesh(world, 1, "cpu")
    half = len(VIDEOS) // world
    batch = batch_of(VIDEOS[rank * half:(rank + 1) * half])
    out = {}
    for name, extra in (("ddp", {}), ("accum", {"grad_accum": 2}),
                        ("zero", {"shard_optimizer_state": True}), ("fsdp", {"shard_params": True})):
        if half % extra.get("grad_accum", 1):
            continue  # a share of one video has no two microbatches
        cfg = cfg_of(**extra)
        res = run_steps(cfg, weights, batch, mesh)
        if name in ("zero", "fsdp"):
            payload = checkpoint_payload(res["state"], 0, cfg)
            if rank == 0:
                save_checkpoint(os.path.join(tmp, f"ckpt_{name}.pth"), payload)
        out[name] = _strip(res)
    for name, extra in (("resume_zero", {"shard_optimizer_state": True}),
                        ("resume_fsdp", {"shard_params": True})):
        cfg = cfg_of(**extra)
        out[name] = _strip(run_steps(cfg, weights, batch, mesh, resume=os.path.join(tmp, "ckpt1.pth")))
    out["eval"] = eval_ranks(rank, world, weights, tmp, mesh)
    return out


def all_ranks(rank, world, weights, tmp, qscales, inputs):
    """``data_axis_ranks``, ``time_axis_ranks`` and ``recalibrate_ranks`` in
    one spawn (a process's start costs seconds): two meshes over one
    process group."""
    return {"data": data_axis_ranks(rank, world, weights, tmp),
            "time": time_axis_ranks(rank, world, weights, qscales, inputs),
            "recalibrate": recalibrate_ranks(rank, world, weights, qscales)}


def recalibrate_ranks(rank, world, weights, qscales):
    """The per-epoch recalibration of a QAT model (``qscales`` baked): each
    rank's drift probe observes its own video, then ``recalibrate`` writes
    the maxima over the ranks. Returns what the rank observed and what its
    observers hold after."""
    from tubedetr_tpu_torch.models.quantize import (
        make_drift_checker,
        model_qscales,
        recalibrate,
        set_model_qscales,
    )
    from tubedetr_tpu_torch.parallel.train_step import model_inputs

    cfg = cfg_of(backbone_quant="int8_qat")
    model = model_from(weights, cfg)
    set_model_qscales(model, qscales)
    half = len(VIDEOS) // world
    inputs = model_inputs(batch_of(VIDEOS[rank * half:(rank + 1) * half]))
    ratio, leaf, observed = make_drift_checker(cfg)(model, inputs)
    recalibrate(cfg, model, observed)
    return {"observed": {k: float(v) for k, v in observed.items()},
            "held": {k: float(v) for k, v in model_qscales(model).items()}, "ratio": ratio}


def time_axis_ranks(rank, world, weights, qscales, inputs):
    """``mesh_time = world``: one dropout-free train step on the four
    videos (every rank reads them all and runs the trunk on its share of
    the frames), then the float inference forward of the same weights and
    the int8_static + fused one (``qscales``: the calibrated maxima by
    buffer name) on ``inputs``, time-sharded."""
    from tubedetr_tpu_torch.models.quantize import set_model_qscales
    from tubedetr_tpu_torch.models.tubedetr import build_model
    from tubedetr_tpu_torch.ops.fused_bottleneck import fused_bottleneck_block
    from tubedetr_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(1, world, "cpu")
    cfg = cfg_of(mesh_time=world)
    out = {"step": _strip(run_steps(cfg, weights, batch_of(), mesh))}
    inputs = {k: torch.from_numpy(v) for k, v in inputs.items()}
    for name, extra in (("float", {}),
                        ("int8", {"backbone_quant": "int8_static", "fused_bottleneck": True})):
        model = model_from(weights, cfg_of(**extra))
        if name == "int8":
            set_model_qscales(model, qscales)
        model.time_group = mesh.time_group
        before = fused_bottleneck_block.launches
        with torch.inference_mode():
            o = model(**inputs)
        assert fused_bottleneck_block.launches == before  # CPU: the plain version
        out[name] = {k: o[k].float().numpy() for k in ("pred_boxes", "pred_sted")}
    return out


EVAL_VIDEOS = dict(n=5, t=T, seed=10, vocab=KW["text_vocab_size"], text_len=6)


def evaluate_videos(cfg, state, batch_size: int, rank: int = 0, world: int = 1, sync_dir=""):
    """``evaluate`` over the five evaluation videos (``EVAL_VIDEOS``),
    this data rank's share in batches of ``batch_size`` (a tail padded by
    repeating its last sample), merged over the ranks: (vIoU summary,
    meters)."""
    from tubedetr_tpu_torch.apps.train import PaddedTail
    from tubedetr_tpu_torch.data.loader import DataLoader
    from tubedetr_tpu_torch.data.synthetic import SyntheticDataset
    from tubedetr_tpu_torch.eval.viou import VIoUEvaluator
    from tubedetr_tpu_torch.parallel.train_step import make_eval_step
    from tubedetr_tpu_torch.train.engine import evaluate

    ds = SyntheticDataset(**EVAL_VIDEOS)
    loader = DataLoader(ds, batch_size=batch_size, t=T, stride=STRIDE,
                        max_text_len=KW["max_text_len"], process_index=rank, process_count=world)
    ev = VIoUEvaluator(ds.annotations)
    stats = evaluate(cfg, make_eval_step(cfg, ema=True), state, PaddedTail(loader), ev)
    ev.synchronize_between_processes(sync_dir)
    return ev.summarize(), stats


def eval_ranks(rank, world, weights, tmp, mesh):
    """The evaluation on ``world`` data ranks of an FSDP state with its EMA
    (``gather_state``: an unsharded copy evaluates), in batches of 2 (the
    shares are uneven, a tail is padded) and of 1 (the meters' batches are
    then the one process's)."""
    from tubedetr_tpu_torch.parallel.mesh import gather_state
    from tubedetr_tpu_torch.parallel.train_step import create_train_state, parallelize

    cfg = cfg_of(shard_params=True)
    state = parallelize(cfg, create_train_state(cfg, model_from(weights, cfg)), mesh)
    eval_state = gather_state(state)
    assert eval_state.model is not state.model and eval_state.parallel is None
    return {bs: evaluate_videos(cfg, eval_state, bs, rank, world, os.path.join(tmp, f"sync{bs}"))
            for bs in (2, 1)}


def nccl_ranks(rank, world, weights):
    """On the card, a rank a card: DDP and FSDP over every rank, one step
    each on this rank's share of the four videos."""
    from tubedetr_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(world, 1, "cuda")
    per = len(VIDEOS) // world
    batch = batch_of(VIDEOS[rank * per:(rank + 1) * per])
    device = f"cuda:{torch.cuda.current_device()}"
    return {name: _strip(run_steps(cfg_of(**extra), weights, batch, mesh, device=device))
            for name, extra in (("ddp", {}), ("fsdp", {"shard_params": True}))}


# ---------------------------------------------------------------------------
# the model axis (tests/test_torch_tp.py)
# ---------------------------------------------------------------------------


def tp_forward(weights, cfg, inputs, mesh, qscales=None):
    """The inference forward of the saved weights cut over ``mesh``'s model
    group (``place_variables_tp``), its trunk's frames split over the time
    group: ``pred_boxes`` and ``pred_sted``, and the layers left whole."""
    from tubedetr_tpu_torch.models.layers import MultiHeadAttention
    from tubedetr_tpu_torch.models.quantize import set_model_qscales
    from tubedetr_tpu_torch.models.roberta import RobertaAttention
    from tubedetr_tpu_torch.parallel.tp import place_variables_tp

    model = model_from(weights, cfg)
    if qscales is not None:
        set_model_qscales(model, qscales)
    place_variables_tp(model, mesh, cfg)
    model.time_group = mesh.time_group if mesh.time > 1 else None
    with torch.inference_mode():
        o = model(**{k: torch.from_numpy(v) for k, v in inputs.items()})
    whole = sorted(n for n, m in model.named_modules()
                   if isinstance(m, (MultiHeadAttention, RobertaAttention))
                   and m.model_group is None)
    return {"pred_boxes": o["pred_boxes"].float().numpy(),
            "pred_sted": o["pred_sted"].float().numpy(), "whole_attention": whole}


def tp_ranks(rank, world, weights, tmp, inputs, qscales):
    """The model axis on ``world`` ranks. On 2: model=2, one step on the
    four videos. On 4: data=2 x model=2 (each data rank on its half) under
    DDP, ZeRO-1 and FSDP (rank 0 writes the DDP and FSDP runs' gathered
    checkpoints), the one-process checkpoint ``tmp/ckpt1.pth`` resumed
    under it, time=2 x model=2 and model=4 on the four videos; then inference on ``inputs``:
    model=4 in float, in int8_static + fused (``qscales``) and with 2 heads
    (which do not divide: the attention stays whole), and time=2 x
    model=2."""
    from tubedetr_tpu_torch.parallel.mesh import make_mesh
    from tubedetr_tpu_torch.train.checkpoint import checkpoint_payload, save_checkpoint

    out = {}
    if world == 2:
        out["tp2"] = _strip(run_steps(cfg_of(), weights, batch_of(), make_mesh(1, 1, "cpu", 2)))
        return out
    mesh = make_mesh(2, 1, "cpu", 2)
    batch = batch_of(VIDEOS[mesh.data_rank * 2:(mesh.data_rank + 1) * 2])
    for name, extra in (("tp", {}), ("tp_zero", {"shard_optimizer_state": True}),
                        ("tp_fsdp", {"shard_params": True})):
        cfg = cfg_of(**extra)
        res = run_steps(cfg, weights, batch, mesh)
        if name in ("tp", "tp_fsdp"):
            payload = checkpoint_payload(res["state"], 0, cfg)
            if rank == 0:
                save_checkpoint(os.path.join(tmp, f"ckpt_{name}.pth"), payload)
        if name == "tp_fsdp":  # the evaluation's copy: whole over data, sliced over model
            from tubedetr_tpu_torch.parallel.mesh import gather_state

            plain = gather_state(res["state"]).model
            with torch.inference_mode():
                o = plain(**{k: torch.from_numpy(v) for k, v in inputs.items()})
            res["eval_forward"] = {k: o[k].float().numpy() for k in ("pred_boxes", "pred_sted")}
        out[name] = _strip(res)
    out["resume_tp"] = _strip(run_steps(cfg_of(shard_optimizer_state=True), weights, batch, mesh,
                                        resume=os.path.join(tmp, "ckpt1.pth")))
    out["tp_time"] = _strip(run_steps(cfg_of(mesh_time=2), weights, batch_of(),
                                      make_mesh(1, 2, "cpu", 2)))
    mesh4 = make_mesh(1, 1, "cpu", 4)
    out["tp4"] = _strip(run_steps(cfg_of(), weights, batch_of(), mesh4))
    out["infer4"] = tp_forward(weights, cfg_of(), inputs, mesh4)
    out["int8_4"] = tp_forward(weights, cfg_of(backbone_quant="int8_static", fused_bottleneck=True),
                               inputs, mesh4, qscales)
    out["heads2"] = tp_forward(weights, cfg_of(nheads=2, text_heads=2), inputs, mesh4)
    out["time2_model2"] = tp_forward(weights, cfg_of(mesh_time=2), inputs,
                                     make_mesh(1, 2, "cpu", 2))
    return out


# ---------------------------------------------------------------------------
# the pipeline (tests/test_torch_pp.py)
# ---------------------------------------------------------------------------


class ToyLayer(torch.nn.Module):
    """One toy layer: ``y + tanh(y @ w + b + aux)``."""

    def __init__(self, w, b):
        super().__init__()
        self.w = torch.nn.Parameter(torch.as_tensor(w).clone())
        self.b = torch.nn.Parameter(torch.as_tensor(b).clone())


def toy_layer_fn(layer, y, aux):
    return y + torch.tanh(y @ layer.w + layer.b + aux)


def toy_stack(ws, bs):
    from tubedetr_tpu_torch.parallel.pp import stack_layer_params

    return stack_layer_params([ToyLayer(w, b) for w, b in zip(ws, bs)])


def pp_ranks(rank, world, toy, grad_case, enc_case, dec_case):
    """The pipeline on ``world`` ranks, ``pipe = stages`` and ``data =
    world // stages``. ``toy``: {(stages, micro): (ws, bs, x, aux)} forward
    cases; ``grad_case``: (ws, bs, x, aux, tgt), pipe=2, 2 microbatches,
    the gradients of this stage's layers and of ``x``; ``enc_case`` /
    ``dec_case``: (layer config, state_dict, inputs) run pipelined; and the
    preplaced stack."""
    from tubedetr_tpu_torch.models.transformer import Decoder, Encoder
    from tubedetr_tpu_torch.parallel.pp import (
        decoder_stack_params,
        make_pipe_mesh,
        pipeline_apply,
        pipelined_decoder_apply,
        pipelined_encoder_apply,
        place_stacked_params,
    )

    out = {"toy": {}}
    meshes = {}

    def mesh_of(stages):
        if stages not in meshes:
            meshes[stages] = make_pipe_mesh(stages, world // stages)
        return meshes[stages]

    t = torch.from_numpy
    for (stages, micro), (ws, bs, x, aux) in toy.items():
        mesh = mesh_of(stages)
        y = pipeline_apply(toy_layer_fn, toy_stack(ws, bs), t(x), t(aux), mesh=mesh,
                           microbatches=micro)
        out["toy"][(stages, micro)] = y.detach().numpy()
    ws, bs, x, aux, tgt = grad_case
    mesh = mesh_of(2)
    stack = toy_stack(ws, bs)
    xt = t(x).requires_grad_(True)
    y = pipeline_apply(toy_layer_fn, stack, xt, t(aux), mesh=mesh, microbatches=2)
    ((y - t(tgt)) ** 2).mean().backward()
    per = len(ws) // 2
    own = range(mesh.stage * per, (mesh.stage + 1) * per)
    out["grad"] = {"x": xt.grad.numpy(), "stage": mesh.stage,
                   "layers": {i: (stack[i].w.grad.numpy(), stack[i].b.grad.numpy()) for i in own},
                   "others_none": all(stack[i].w.grad is None for i in range(len(ws))
                                      if i not in own)}
    # the preplaced stack: this stage's layers only, the same numbers
    mesh = mesh_of(4)
    full = toy_stack(ws, bs)
    placed = place_stacked_params(full, mesh)
    out["placed"] = [pipeline_apply(toy_layer_fn, s, t(x), t(aux), mesh=mesh, microbatches=2).detach().numpy()
                     for s in (full, placed)]
    out["placed_layers"] = len(placed.layers)
    (d, heads, ffn, layers), sd, (xe, pos, mask) = enc_case
    enc = Encoder(layers, d, heads, ffn)
    enc.load_state_dict({k: t(v) for k, v in sd.items()})
    out["enc"] = {}
    for stages, micro in ((2, 4), (4, 2)):
        out["enc"][(stages, micro)] = pipelined_encoder_apply(
            enc.layers, t(xe), t(pos), t(mask), mesh=mesh_of(stages), microbatches=micro).detach().numpy()
    (d, heads, ffn, layers), sd, args = dec_case
    dec = Decoder(layers, d, heads, ffn)
    dec.load_state_dict({k: t(v) for k, v in sd.items()})

    class _Holder(torch.nn.Module):  # decoder_stack_params reads model.transformer.decoder
        def __init__(self):
            super().__init__()
            self.transformer = torch.nn.Module()
            self.transformer.decoder = dec

    hs, tsa, cross = pipelined_decoder_apply(decoder_stack_params(_Holder()),
                                             *[t(a) for a in args], mesh=mesh_of(2),
                                             microbatches=4)
    out["dec"] = [dec.norm(hs).detach().numpy(), tsa.detach().numpy(), cross.detach().numpy()]
    return out


# ---------------------------------------------------------------------------
# the collective inventory (tests/test_torch_collectives.py)
# ---------------------------------------------------------------------------


def inventory_dicts(inv):
    return {"colls": [dict(kind=c.kind, axes=c.axes, result_bytes=c.result_bytes,
                           rank_bytes=c.rank_bytes, group_size=c.group_size, name=c.name,
                           shapes=c.shapes) for c in inv],
            "profiler_events": inv.profiler_events}


def collective_ranks(rank, world, weights, inputs):
    """One traced step a leg on 4 ranks: the time-split inference (data=2 x
    time=2), a ZeRO-1 train step (data=2 x time=2), a TP + FSDP train step
    (data=2 x model=2) and the toy pipeline (pipe=4)."""
    from tubedetr_tpu_torch.parallel.collectives import collective_inventory
    from tubedetr_tpu_torch.parallel.mesh import make_mesh
    from tubedetr_tpu_torch.parallel.pp import make_pipe_mesh, pipeline_apply
    from tubedetr_tpu_torch.parallel.train_step import (
        create_train_state,
        make_train_step,
        parallelize,
    )

    out = {}
    mesh = make_mesh(2, 2, "cpu")
    model = model_from(weights, cfg_of(mesh_time=2))
    model.time_group = mesh.time_group
    x = {k: torch.from_numpy(v) for k, v in inputs.items()}

    def infer():
        with torch.inference_mode():
            return model(**x)["pred_boxes"]

    out["infer"] = inventory_dicts(collective_inventory(infer, mesh))
    for name, extra, shape in (("zero", {"shard_optimizer_state": True, "mesh_time": 2}, (2, 2, 1)),
                               ("tp_fsdp", {"shard_params": True}, (2, 1, 2))):
        mesh = make_mesh(shape[0], shape[1], "cpu", shape[2])
        cfg = cfg_of(**extra)
        state = parallelize(cfg, create_train_state(cfg, model_from(weights, cfg)), mesh)
        batch = batch_of(VIDEOS[mesh.data_rank * 2:(mesh.data_rank + 1) * 2])
        step = make_train_step(cfg, deterministic=True)
        out[name] = inventory_dicts(collective_inventory(lambda: step(state, batch, LRS, 0), mesh))
    mesh = make_pipe_mesh(4)
    rng = np.random.RandomState(0)
    stack = toy_stack([rng.randn(8, 8).astype(np.float32) for _ in range(4)],
                      [np.zeros(8, np.float32)] * 4)
    xs, aux = torch.ones(8, 8), torch.zeros(8, 8)
    out["pipe"] = inventory_dicts(collective_inventory(
        lambda: pipeline_apply(toy_layer_fn, stack, xs, aux, mesh=mesh, microbatches=4), mesh))
    return out
