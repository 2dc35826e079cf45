"""Provenance stamp (counterpart of smmb_tpu/utils/stamp.py).

Every CLI mode of the port prints ``[stamp] git=<sha>[+dirty] date=<utc>``
as its first line, so a kept output names the commit it measured. "dirty"
counts only the paths that change what is measured: the port, the scripts,
``chip_smoke.py`` and the tests. Outside a git checkout the sha reads
``unknown``.
"""

from __future__ import annotations

import datetime
import os
import subprocess

CODE_PATHS = ("smmb_tpu_torch", "scripts", "chip_smoke.py", "tests")


def git_head(repo: str | None = None) -> str:
    """HEAD's sha (12 hex) + '+dirty' if the code paths have changes."""
    repo = repo or os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        sha = subprocess.run(["git", "rev-parse", "--short=12", "HEAD"], cwd=repo,
                             capture_output=True, text=True, timeout=10).stdout.strip()
        dirty = subprocess.run(["git", "status", "--porcelain", "--untracked-files=no",
                                "--", *CODE_PATHS], cwd=repo, capture_output=True,
                               text=True, timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    if not sha:
        return "unknown"
    return sha + ("+dirty" if dirty else "")


def stamp() -> str:
    now = datetime.datetime.now(datetime.timezone.utc)
    return f"[stamp] git={git_head()} date={now.isoformat(timespec='seconds')}"


def print_stamp() -> None:
    """Print the stamp (first, in every CLI mode)."""
    print(stamp(), flush=True)
