"""The git banner and the profiler hooks (counterpart of ``tubedetr_tpu/utils/misc.py``).

``maybe_profile`` traces a whole block and ``ProfileWindow`` a bounded
window of training steps, both with ``torch.profiler`` (CPU activities,
and CUDA ones where a card is present), each writing a Chrome trace
(``*.pt.trace.json``) into ``TUBEDETR_PROFILE_DIR`` (or the directory
given). The window is steps ``[TUBEDETR_PROFILE_START, +TUBEDETR_PROFILE_STEPS)``
of an epoch (defaults 1 and 3: step 0 warms up). Without a directory both
do nothing.
"""

from __future__ import annotations

import os
import subprocess
import time
from contextlib import contextmanager


def get_sha() -> str:
    """'sha: ..., status: ..., branch: ...' of the checkout holding the
    package ("N/A" outside a git checkout)."""
    cwd = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    def run(cmd):
        try:
            return subprocess.check_output(cmd, cwd=cwd, stderr=subprocess.DEVNULL).decode("ascii").strip()
        except (OSError, subprocess.CalledProcessError):
            return "N/A"

    sha = run(["git", "rev-parse", "HEAD"])
    diff = run(["git", "diff-index", "HEAD"])
    branch = run(["git", "rev-parse", "--abbrev-ref", "HEAD"])
    status = "clean" if diff in ("", "N/A") else "has uncommitted changes"
    return f"sha: {sha}, status: {status}, branch: {branch}"


def _start_trace():
    """A started ``torch.profiler.profile``: CPU activities, and CUDA ones
    when a card is present."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_trace(prof, trace_dir: str) -> str:
    """Stop ``prof`` and write its Chrome trace into ``trace_dir``; returns the file."""
    prof.stop()
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"trace-{os.getpid()}-{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


@contextmanager
def maybe_profile(trace_dir: str = ""):
    """Trace the block inside when ``TUBEDETR_PROFILE_DIR`` (or the
    argument) names a directory; a bounded window of training steps is
    ``ProfileWindow``'s."""
    trace_dir = trace_dir or os.environ.get("TUBEDETR_PROFILE_DIR", "")
    if not trace_dir:
        yield
        return
    prof = _start_trace()
    try:
        yield
    finally:
        _stop_trace(prof, trace_dir)


class ProfileWindow:
    """Trace steps ``[TUBEDETR_PROFILE_START, +TUBEDETR_PROFILE_STEPS)`` of
    the epoch it is made for (defaults 1 and 3; malformed values fall back
    to them) into ``TUBEDETR_PROFILE_DIR``. Call ``step(i)`` with the step's
    index in the epoch before each step and ``close()`` after the loop (it
    also ends a window the epoch was too short to fill)."""

    def __init__(self, trace_dir: str = "", enabled: bool = True):
        self.trace_dir = trace_dir or os.environ.get("TUBEDETR_PROFILE_DIR", "")
        if not enabled:
            self.trace_dir = ""
        try:
            self.start = int(os.environ.get("TUBEDETR_PROFILE_START", "1"))
            self.steps = int(os.environ.get("TUBEDETR_PROFILE_STEPS", "3"))
        except ValueError:
            self.start, self.steps = 1, 3
        self._prof = None
        self._active = False
        self._done = False

    def step(self, i: int) -> None:
        if not self.trace_dir or self._done:
            return
        if not self._active and i >= self.start:
            self._prof = _start_trace()
            self._active = True
            print(f"[profile] tracing steps {i}..{i + self.steps - 1} -> {self.trace_dir}")
        elif self._active and i >= self.start + self.steps:
            self.close()

    def close(self) -> None:
        if self._active:
            _stop_trace(self._prof, self.trace_dir)
            self._prof, self._active, self._done = None, False, True
            print(f"[profile] trace written to {self.trace_dir}")
