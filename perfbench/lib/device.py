"""The card a run uses: the check that it is there, its name, its power limit
and the peak memory the run allocated on it."""

from __future__ import annotations

import shutil
import subprocess
import sys

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "int8": torch.int8}


def require(chips: int, allow_cpu: bool = False) -> torch.device:
    """The CUDA device of the run. Exits (code 3, no result) when there is no
    card or fewer than the cell asks for; ``allow_cpu`` (the harness's own
    tests) runs on the CPU instead."""
    if allow_cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: the cell needs {chips} CUDA device(s), found {have}",
              file=sys.stderr)
        raise SystemExit(3)
    return torch.device("cuda", 0)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def info(dev: torch.device, chips: int) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them, or an
    empty string where it cannot."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return ""
    try:
        out = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=False)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
