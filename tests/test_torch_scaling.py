"""Port parity: the scaling harness (smmb_tpu_torch.bench.scaling, the
``scaling`` CLI mode) — the twin of tests/test_aux.py:41 — and the
provenance stamp every CLI mode prints first (smmb_tpu_torch.utils.stamp;
JAX's tests assert nothing of it, so its format is held here).

On the CPU each mesh size is one gloo world of CPU ranks, timed by the
host's clock (the numbers mean nothing here; the machinery is what runs),
and every point is labelled as sharing its host.
"""

import os
import re
import subprocess
import sys

import pytest
import torch

from smmb_tpu.bench.scaling import run_scaling as j_run_scaling
from smmb_tpu_torch.bench.scaling import run_scaling
from smmb_tpu_torch.utils.stamp import git_head, stamp

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARTS = ("column", "row", "overlap", "bcsr_column")
STAMP = re.compile(r"^\[stamp\] git=([0-9a-f]{12}(\+dirty)?|unknown) "
                   r"date=\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d\+00:00$")


def test_scaling_harness_cpu():
    pts = run_scaling(m=8, k=1024, n=1024, non_zero=2, mesh_shapes=((1, 1), (1, 2)),
                      partitionings=PARTS, iters=2, reps=2, device="cpu")
    jax_pts = j_run_scaling(m=8, k=1024, n=1024, non_zero=2, mesh_shapes=((1, 1), (1, 2)),
                            partitioning="column", iters=2, reps=2, use_kernel=False)
    for part in PARTS:
        mine = [p for p in pts if p.partitioning == part]
        assert len(mine) == 2, part
        assert [(p.devices, p.mesh) for p in mine] == [(p.devices, p.mesh) for p in jax_pts]
        assert mine[0].efficiency == 1.0
        assert all(p.nnz_per_s > 0 and p.mean_s > 0 for p in mine), part
        assert all(p.shared and p.timer == "host" and p.backend == "gloo" for p in mine)


def test_scaling_ep_moe_is_the_next_slice():
    with pytest.raises(NotImplementedError, match="later slice"):
        run_scaling(partitioning="ep_moe", device="cpu")
    with pytest.raises(ValueError):
        run_scaling(partitioning="bogus", device="cpu")


def test_stamp_format():
    assert STAMP.match(stamp()), stamp()
    head = git_head(REPO)
    assert head == "unknown" or re.fullmatch(r"[0-9a-f]{12}(\+dirty)?", head)


def test_cli_prints_stamp_first():
    r = subprocess.run([sys.executable, "-m", "smmb_tpu_torch", "no-such-mode"], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 2
    lines = r.stdout.splitlines()
    assert STAMP.match(lines[0]), lines[:2]
    assert "scaling" in r.stdout  # the usage names the new mode
