"""Checkpoints: save, load, resume, and the warm-start surgery (counterpart of ``tubedetr_tpu/train/checkpoint.py``).

The port's checkpoint is the reference's ``.pth`` payload, ``{"model",
"model_ema", "optimizer", "epoch", "args"}``, plus ``step`` (the train
step count: the dropout seed and the optimizer's bias correction follow
it) and ``qscales`` (the calibrated int8 activation maxima by buffer name,
or None), written by ``torch.save`` to ``path + ".tmp"`` and renamed into
place, so a crash leaves the old file whole. ``model_ema`` is a full
``state_dict`` with the EMA parameters, so a reference loader reads it as
it reads the reference's. ``AsyncCheckpointWriter`` copies the payload to
host memory at once and writes it on a thread.

``--load`` (``load_pretrained``) takes a reference or port ``.pth``: the
EMA weights when present, ``query_embed`` cut to ``num_queries``, the sine
time-embedding buffer dropped, the reference's learned position grid
(``backbone.1.{row,col}_embed``) moved to the port's top-level names,
``--rd_init_tsa`` keeping the decoder's temporal self-attention at init,
and the rest merged non-strictly. A trunk's norms are GroupNorm when the
checkpoint has no ``bn1.running_mean`` (as the JAX package's
``convert_resnet`` reads it); a checkpoint whose trunk family (ResNet,
EfficientNet, RegNet, ConvNeXt: ``interop/from_jax.py:trunk_family``) or
norms are not the model's is refused. A JAX
package checkpoint (a ``.ckpt`` pickle or an orbax directory) is refused:
its ``opt_state`` unpickles only with ``optax`` installed.
"""

from __future__ import annotations

import dataclasses
import os
import re
import threading
import zipfile
from typing import Dict, Optional

import numpy as np
import torch

from tubedetr_tpu_torch.interop.from_jax import trunk_family

JAX_CHECKPOINT_HELP = (
    "not a torch.save zip file. A JAX package checkpoint (a .ckpt pickle or an orbax "
    "directory) does not load here: its opt_state unpickles only with optax installed. "
    "Convert its variables with interop/from_jax.py:params_from_jax and save that "
    "state_dict as .pth"
)
TSA_KEYS = re.compile(r"transformer\.decoder\.layers\.\d+\.self_attn\.")


def warm_start_surgery(sd: Dict, num_queries: int) -> Dict:
    """A copy of ``sd`` with ``query_embed.weight`` cut to ``num_queries``
    rows and the sine time-embedding buffer dropped (it is regenerated at
    the model's ``video_max_len``)."""
    sd = dict(sd)
    if "query_embed.weight" in sd and sd["query_embed.weight"].shape[0] > num_queries:
        sd["query_embed.weight"] = sd["query_embed.weight"][:num_queries]
    sd.pop("transformer.time_embed.te", None)
    for grid in ("row_embed", "col_embed"):  # the reference's Joiner holds them
        if f"backbone.1.{grid}.weight" in sd:
            sd[f"{grid}.weight"] = sd.pop(f"backbone.1.{grid}.weight")
    return sd


def trunk_norm(sd: Dict) -> Optional[str]:
    """'gn' or 'frozen_bn' for the norm of the trunk's ``bn1`` a
    ``state_dict`` holds (GroupNorm has no running statistics; an
    EfficientNet's ``bn1`` is a FrozenBN), None without one (no trunk, a
    RegNet, a ConvNeXt)."""
    if "backbone.0.body.bn1.weight" not in sd:
        return None
    return "frozen_bn" if "backbone.0.body.bn1.running_mean" in sd else "gn"


# ---------------------------------------------------------------------------
# the payload
# ---------------------------------------------------------------------------


def checkpoint_payload(state, epoch: int, cfg, qscales: Optional[Dict] = None) -> Dict:
    """The payload of ``state`` (a ``TrainState``) after ``epoch``, in one
    process's format whatever the state's sharding: a ZeRO-1 or FSDP state
    is gathered first (``parallel/mesh.py:full_state_dicts``, a collective:
    every rank calls this, and rank 0 writes what it returns). The tensors
    of a replicated state are the live ones: ``snapshot`` copies them."""
    from tubedetr_tpu_torch.parallel.mesh import full_state_dicts

    model_sd, ema_params, optimizer_sd = full_state_dicts(state)
    ema = None
    if ema_params is not None:
        ema = {k: ema_params.get(k, v) for k, v in model_sd.items()}
    return {
        "model": model_sd,
        "model_ema": ema,
        "optimizer": optimizer_sd,
        "epoch": int(epoch),
        "args": dataclasses.asdict(cfg),
        "step": int(state.step),
        "qscales": None if qscales is None else {k: torch.as_tensor(np.asarray(v, np.float32))
                                                  for k, v in qscales.items()},
    }


def snapshot(obj):
    """A copy of ``obj`` whose every tensor is a new host tensor
    (``.detach().to("cpu", copy=True)``) and every array a copy: the
    optimizer updates the live tensors in place."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, np.ndarray):
        return obj.copy()
    if isinstance(obj, dict):
        return type(obj)((k, snapshot(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(snapshot(v) for v in obj)
    return obj


def save_checkpoint(path: str, payload: Dict) -> None:
    """``torch.save`` to ``path + ".tmp"``, then an atomic rename to ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


class AsyncCheckpointWriter:
    """Checkpoint writes behind training (``--async_checkpoint``).

    ``save`` first joins the write in flight (at most one; checkpoints land
    in order), then copies the payload to host memory before it returns
    (``snapshot``: the next optimizer step changes the parameters and
    moments in place), and leaves ``torch.save`` and the rename to a
    thread. A failed write re-raises on the next ``save`` or ``wait``."""

    def __init__(self):
        self._thread = None
        self._error = None

    def _join(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, path: str, payload: Dict) -> None:
        self._join()
        snap = snapshot(payload)

        def write():
            try:
                save_checkpoint(path, snap)
            except BaseException as e:  # noqa: BLE001 - re-raised by the next save() or wait()
                self._error = e

        self._thread = threading.Thread(target=write, name="ckpt-writer", daemon=False)
        self._thread.start()

    def wait(self) -> None:
        """Join the write in flight; raises if it failed."""
        self._join()


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------


def load_checkpoint(path: str) -> Dict:
    """A ``.pth`` file as written by ``torch.save`` (the port's or the
    reference's; load only files you trust). A JAX package checkpoint is
    refused with the route for its weights."""
    if os.path.isdir(path) or not zipfile.is_zipfile(path):
        raise ValueError(f"{path}: {JAX_CHECKPOINT_HELP}")
    return torch.load(path, map_location="cpu", weights_only=False)


def preferred_state_dict(ckpt: Dict) -> Dict:
    """The EMA ``state_dict`` when the checkpoint has one, else ``model``,
    else the file itself as a bare ``state_dict``."""
    if ckpt.get("model_ema") is not None:
        return ckpt["model_ema"]
    if "model" in ckpt:
        return ckpt["model"]
    return ckpt


def load_torch_state_dict(path: str) -> Dict:
    """The preferred ``state_dict`` of a ``.pth`` file (EMA first)."""
    return dict(preferred_state_dict(load_checkpoint(path)))


def load_pretrained(model: torch.nn.Module, path_or_ckpt, rd_init_tsa: bool = False):
    """``--load``: the surgery on the preferred ``state_dict`` and a
    non-strict load into ``model`` (a shape mismatch raises). With
    ``rd_init_tsa`` the decoder's temporal self-attention keeps its init.
    Returns (missing, unexpected) key lists."""
    sd = (load_torch_state_dict(path_or_ckpt) if isinstance(path_or_ckpt, str)
          else preferred_state_dict(path_or_ckpt))
    sd = warm_start_surgery(sd, model.query_embed.weight.shape[0])
    own = model.state_dict()
    have, want = trunk_family(sd), trunk_family(own)
    if have and have != want:
        raise ValueError(f"the checkpoint holds a {have} trunk, the model a {want} one")
    have, want = trunk_norm(sd), trunk_norm(own)
    if have is not None and have != want:
        raise ValueError(f"the checkpoint's trunk norms are {have}, the model's {want} "
                         "(a -gn backbone loads a GroupNorm checkpoint)")
    if rd_init_tsa:
        sd = {k: v for k, v in sd.items() if not TSA_KEYS.match(k)}
    result = model.load_state_dict(sd, strict=False)
    return list(result.missing_keys), list(result.unexpected_keys)


def resume_state(state, ckpt: Dict) -> int:
    """``--resume``: the parameters, the EMA, the optimizer's moments and
    step counts and the train step count of ``ckpt`` into ``state``, a
    one-process state (``parallel/train_step.py:parallelize`` reshards it
    afterwards); returns the epoch to start at (the saved one + 1)."""
    state.model.load_state_dict(ckpt["model"])
    if state.ema_params is not None and ckpt.get("model_ema") is not None:
        with torch.no_grad():
            for k, t in state.ema_params.items():
                t.copy_(ckpt["model_ema"][k])
    if state.optimizer is not None and ckpt.get("optimizer") is not None:
        state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt.get("step", 0))
    return int(ckpt.get("epoch", -1)) + 1
