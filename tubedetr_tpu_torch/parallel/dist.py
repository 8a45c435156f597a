"""The multi-process runtime (counterpart of ``tubedetr_tpu/parallel/dist.py``).

* ``init_distributed_mode`` reads the launcher's environment, as the
  reference's ``util/dist.py:210-247``: ``torchrun`` (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) or SLURM
  (``SLURM_PROCID``, ``SLURM_NTASKS``, ``SLURM_LOCALID``; the first host of
  ``SLURM_JOB_NODELIST`` is the rendezvous unless ``MASTER_ADDR`` is set).
  Without either it does nothing and returns False. On the card it binds
  the process to ``cuda:LOCAL_RANK`` before the process group is made (every
  rank's NCCL communicator and kernel launches would fall on card 0
  otherwise) and takes NCCL; gloo is taken only for ``--device cpu``. A
  failed init raises: a launcher environment never degrades to one process.
* ``setup_print_for_distributed``: ranks other than 0 print only with
  ``force=True``.
* ``barrier``, ``all_agree`` and ``sync_meters_between_processes``, the
  epoch-end all-reduce of each meter's ``(count, total)``
  (the reference's ``util/metrics.py:33-45``).
* ``allreduce_max``: the elementwise maximum over the ranks, for the int8
  calibration's maxima.

The JAX package's warm-up collective exists for XLA's compile skew; here
the barrier before the first step (``train/engine.py``) is all it needs.
"""

from __future__ import annotations

import builtins
import os
import re
from dataclasses import dataclass
from typing import Dict, Mapping, Optional

import torch
import torch.distributed as dist

_print_orig = builtins.print


@dataclass(frozen=True)
class LaunchEnv:
    """What a launcher told this process: its rank among ``world`` and its
    rank on its node (the card it drives), and where the ranks meet."""

    rank: int
    world: int
    local_rank: int
    master_addr: str
    master_port: str


def slurm_first_host(nodelist: str) -> str:
    """The first host of a SLURM node list: ``"gpu[03-04,07],cpu1"`` -> ``"gpu03"``."""
    m = re.match(r"([^,\[]+)(?:\[([^\]]+)\])?", nodelist.strip())
    if not m:
        raise ValueError(f"cannot read the SLURM node list {nodelist!r}")
    prefix, ranges = m.group(1), m.group(2)
    if not ranges:
        return prefix
    return prefix + ranges.split(",")[0].split("-")[0]


def launch_env(environ: Optional[Mapping[str, str]] = None) -> Optional[LaunchEnv]:
    """The launcher's environment, or None for a single process: torchrun's
    variables first, then SLURM's (a job of more than one task)."""
    env = os.environ if environ is None else environ
    if "RANK" in env and "WORLD_SIZE" in env:
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        local = int(env.get("LOCAL_RANK", rank))
        addr, port = env.get("MASTER_ADDR", "127.0.0.1"), env.get("MASTER_PORT", "29500")
    elif "SLURM_PROCID" in env and int(env.get("SLURM_NTASKS", "1")) > 1:
        rank, world = int(env["SLURM_PROCID"]), int(env["SLURM_NTASKS"])
        local = int(env.get("SLURM_LOCALID", "0"))
        addr = env.get("MASTER_ADDR") or slurm_first_host(env.get("SLURM_JOB_NODELIST", "127.0.0.1"))
        # a port a job, so that two jobs on one node do not meet
        port = env.get("MASTER_PORT") or str(15000 + int(env.get("SLURM_JOB_ID", "0")) % 20000)
    else:
        return None
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    return LaunchEnv(rank, world, local, addr, port)


def init_process_group(device: torch.device, rank: int, world: int, init_method: str,
                       local_rank: int = 0) -> None:
    """The default process group: NCCL on the card (the process bound to
    ``cuda:local_rank`` first), gloo on the CPU; raises if it cannot be made."""
    if device.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("this PyTorch has no NCCL: multi-GPU runs need it")
        torch.cuda.set_device(local_rank)
        dist.init_process_group("nccl", init_method=init_method, rank=rank, world_size=world,
                                device_id=torch.device("cuda", local_rank))
    elif device.type == "cpu":
        dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=world)
    else:
        raise ValueError(f"no process group backend for device {device}")


def init_distributed_mode(device, environ: Optional[Mapping[str, str]] = None) -> bool:
    """Join the launcher's process group; False (and nothing done) without
    a launcher environment. ``device`` is the run's device (``--device``)."""
    env = launch_env(environ)
    if env is None:
        return False
    device = torch.device(device)
    init_process_group(device, env.rank, env.world,
                       f"tcp://{env.master_addr}:{env.master_port}", env.local_rank)
    return True


def device_for(device) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` on the card once the process
    group has bound it (``init_process_group``), else ``device`` itself."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and is_dist_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return device


def is_dist_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    return dist.get_rank() if is_dist_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if is_dist_initialized() else 1


def is_main_process() -> bool:
    return get_rank() == 0


def setup_print_for_distributed(is_master: bool) -> None:
    """Ranks other than the master print only with ``force=True``."""

    def print_maybe(*args, **kwargs):
        force = kwargs.pop("force", False)
        if is_master or force:
            _print_orig(*args, **kwargs)

    builtins.print = print_maybe


def restore_print() -> None:
    builtins.print = _print_orig


def comm_device() -> torch.device:
    """Where a tensor for a collective must lie: the current card under
    NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier(name: str = "barrier") -> None:
    """Every rank waits here for the others; nothing without a process
    group. ``name`` says at the call site what the ranks wait for."""
    if is_dist_initialized():
        dist.barrier()


def all_agree(flag: bool) -> bool:
    """True only if ``flag`` is true on every rank: a decision that a
    collective follows (a cache hit, say) is taken by all ranks alike."""
    if not is_dist_initialized():
        return bool(flag)
    t = torch.tensor([1 if flag else 0], dtype=torch.int32, device=comm_device())
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())


def allreduce_max(values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``values`` with each tensor replaced by its elementwise maximum over
    the ranks (one all-reduce); ``values`` itself without a process group.
    Every rank passes the same keys and shapes."""
    if not is_dist_initialized() or not values:
        return values
    keys = sorted(values)
    flat = torch.cat([values[k].detach().reshape(-1).double().cpu() for k in keys])
    flat = flat.to(comm_device())
    dist.all_reduce(flat, op=dist.ReduceOp.MAX)
    out, i = {}, 0
    flat = flat.cpu()
    for k in keys:
        v = values[k]
        out[k] = flat[i:i + v.numel()].reshape(v.shape).to(v.dtype)
        i += v.numel()
    return out


def sync_meters_between_processes(meters: Dict) -> None:
    """All-reduce every meter's ``(count, total)`` in place; the keys are
    the union of the ranks' (a meter that a rank lacks counts 0 there)."""
    if not is_dist_initialized():
        return
    names = [None] * get_world_size()
    dist.all_gather_object(names, sorted(meters))
    keys = sorted(set().union(*names))
    if not keys:
        return
    local = torch.tensor([[float(meters[k].count), float(meters[k].total)] if k in meters
                          else [0.0, 0.0] for k in keys], dtype=torch.float64,
                         device=comm_device())
    dist.all_reduce(local)
    from tubedetr_tpu_torch.train.logging import SmoothedValue

    for k, (count, total) in zip(keys, local.cpu().tolist()):
        m = meters.get(k)
        if m is None:
            m = meters[k] = SmoothedValue()
        m.count, m.total = int(count), float(total)
