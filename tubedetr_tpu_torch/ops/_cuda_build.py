"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, ``build/lib<name>.so`` inside this package
(listed in ``.gitignore``). A library is rebuilt when its source, or any
``csrc/*.cuh`` header (the sources include them by name), is newer.
``build_all`` starts one ``nvcc`` per source at once and waits for all of
them. Nothing here runs at import time: the CPU tests import every module of
the port on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
            "tubedetr_tpu_torch build on a machine with the CUDA toolkit"
        )
    return path


def sources() -> list:
    """Names of every kernel source under ``csrc/``."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _paths(name: str):
    return (
        os.path.join(CSRC, f"{name}.cu"),
        os.path.join(BUILD, f"lib{name}.so"),
        os.path.join(BUILD, f"lib{name}.log"),
    )


def _stale(name: str) -> bool:
    src, lib, _ = _paths(name)
    if not os.path.exists(lib):
        return True
    headers = [os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh")]
    return os.path.getmtime(lib) < max(os.path.getmtime(f) for f in [src, *headers])


def nvcc_command(src: str, out: str) -> list:
    """The command that compiles the kernel source ``src`` into the shared
    library ``out``."""
    return [_nvcc(), *NVCC_FLAGS, "-o", out, src]


def build_all(names: Iterable[str]) -> Dict[str, str]:
    """Compile every stale library among ``names`` in parallel; returns the
    compiler output (``-Xptxas -v``: registers, spills) of each build."""
    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for name in names:
        if not _stale(name):
            continue
        src, lib, _ = _paths(name)
        tmp = f"{lib}.{os.getpid()}.tmp"
        procs[name] = (tmp, subprocess.Popen(
            nvcc_command(src, tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    logs = {}
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        _, lib, log = _paths(name)
        with open(log, "w") as f:
            f.write(out)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
        os.replace(tmp, lib)  # atomic: concurrent loaders never see a partial file
        logs[name] = out
    return logs


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")
_NOTE = re.compile(r"warning|\(C\d+\)")


def build_log(name: str) -> str:
    """The compiler output of the last build of ``lib<name>.so`` ("" if none)."""
    path = _paths(name)[2]
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def ptxas_usage(log: str) -> Dict[str, dict]:
    """Per kernel entry of an ``nvcc -Xptxas -v`` log, by mangled name: its
    registers, stack frame, spill stores and loads and static shared memory
    (bytes), and the ptxas warnings and numbered notes printed while it was
    compiled."""
    usage: Dict[str, dict] = {}
    entry = props = None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            entry = props = m.group(1)
            usage[entry] = {"registers": None, "stack_bytes": 0, "spill_store_bytes": 0,
                            "spill_load_bytes": 0, "smem_bytes": 0, "notes": []}
            continue
        m = _PROPS.search(line)
        if m:
            props = m.group(1)
            continue
        if entry is None:
            continue
        m = _FRAME.search(line)
        if m:
            if props == entry:
                usage[entry].update(zip(("stack_bytes", "spill_store_bytes", "spill_load_bytes"),
                                        map(int, m.groups())))
            continue
        m = _USED.search(line)
        if m:
            smem = _SMEM.search(line)
            usage[entry].update(registers=int(m.group(1)),
                                smem_bytes=int(smem.group(1)) if smem else 0)
        elif _NOTE.search(line):
            usage[entry]["notes"].append(line.strip())
    return usage


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``lib<name>.so``, built first if stale."""
    with _lock:
        if name not in _loaded:
            build_all([name])
            _loaded[name] = ctypes.CDLL(_paths(name)[1])
        return _loaded[name]
