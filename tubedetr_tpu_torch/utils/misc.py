"""The git banner of the CLI's first line (counterpart of ``tubedetr_tpu/utils/misc.py:get_sha``)."""

from __future__ import annotations

import os
import subprocess


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
