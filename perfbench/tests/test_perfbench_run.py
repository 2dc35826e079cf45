"""The harness end to end on the CPU at tiny copies of the cells: the result
line, the faults that must make ``correct`` false, the control, and what
the run imports. The look for a card is skipped (``allow_cpu``); the port's
kernels run their plain versions. A run on the card is marked ``cuda``."""

from __future__ import annotations

import io
import json
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

from perfbench_tiny_cells import CELLS, REPO, write_root

from perfbench import calibrate, run
from perfbench.lib import spec

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    base = tmp_path_factory.mktemp("tiny")
    return base, write_root(base)


def _run(root, cell, argv_extra=(), seconds="0.3"):
    base, manifest = root
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = run.main(["--workload", cell, "--seed", "2147483659", "--seconds", seconds,
                       *argv_extra], allow_cpu=True, manifest=manifest, data_root=base)
    assert rc == 0
    lines = out.getvalue().strip().splitlines()
    return json.loads(lines[-1]), err.getvalue().strip().splitlines()


@pytest.mark.parametrize("cell", sorted(CELLS.values()))
def test_result_line(root, cell):
    res, err = _run(root, cell)
    assert list(res) == KEYS
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    c = spec.load_cell(cell, root[1], root[0])
    assert set(res["metrics"]) == {m["name"] for m in c.end_to_end()}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    # each compared number ends standard error, beside its limit
    tail = err[-len(res["checks"]):]
    assert [line.split(":")[0] for line in tail] == [f"check {n}" for n in res["checks"]]


def _half(fn):
    def f(self, *a, **k):
        out = fn(self, *a, **k)
        y = out[0] if isinstance(out, tuple) else out
        y = y.clone()
        y[y.shape[0] // 2:] = 0
        return (y, *out[1:]) if isinstance(out, tuple) else y
    return f


def _altered(fn):
    """The first row's answer altered where it is produced (its logits or
    outputs rotated by one, so its token moves too)."""
    def f(self, *a, **k):
        out = fn(self, *a, **k)
        y = out[0] if isinstance(out, tuple) else out
        y = y.clone()
        y[0] = torch.roll(y[0], 1, dims=-1)
        return (y, *out[1:]) if isinstance(out, tuple) else y
    return f


def _unchanged(fn):
    """A decode step that returns its cache as it was given (position not
    advanced)."""
    def f(self, tok, cache, *a, **k):
        logits, _ = fn(self, tok, [dict(c) for c in cache], *a, **k)
        return logits, cache
    return f


FAULTS = [
    ("tiny.mlp", "forward", _half), ("tiny.mlp", "forward", _altered),
    ("tiny.prefill", "prefill", _half), ("tiny.prefill", "prefill", _altered),
    ("tiny.decode", "decode", _half), ("tiny.decode", "decode", _altered),
    ("tiny.decode", "decode", _unchanged),
]


@pytest.mark.parametrize("cell,method,fault", FAULTS,
                         ids=[f"{c}-{f.__name__.strip('_')}" for c, _, f in FAULTS])
def test_fault_is_not_correct(root, monkeypatch, cell, method, fault):
    c = spec.load_cell(cell, root[1], root[0])
    cls = spec.system_module(c.config).System
    monkeypatch.setattr(cls, method, fault(getattr(cls, method)))
    res, _ = _run(root, cell)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell", sorted(CELLS.values()))
def test_control_is_not_correct(root, cell):
    """The cell's control (the MLP: the program's W2A8 path; the LM: the
    reference rounded to fp8 in the program's place, one precision below the
    configuration's bf16) reads beyond a limit that every sound seed meets."""
    base, manifest = root
    with redirect_stdout(io.StringIO()):
        rows = calibrate.main(["--workload", cell, "--seconds", "0.3", "--seeds", "1", "2",
                               "--control-seeds", "3", "4"],
                              allow_cpu=True, manifest=manifest, data_root=base)
    limits = spec.load_cell(cell, manifest, base).workload["check"]["limits"]
    for r in rows:
        within = all(v <= limits[n] for n, v in r["numbers"].items())
        assert within != bool(r["control"]), r


def test_no_jax_in_the_run(root, tmp_path):
    """Nothing a run imports has ``jax``, ``jaxlib``, ``flax`` or the JAX
    package as its whole top-level name (``smmb_tpu_torch`` is the port)."""
    base, manifest = root
    code = (
        "import sys, io, contextlib; sys.path.insert(0, %r)\n"
        "from pathlib import Path\n"
        "from perfbench import run\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    run.main(['--workload', 'tiny.decode', '--seed', '5', '--seconds', '0.2'],"
        " allow_cpu=True, manifest=Path(%r), data_root=Path(%r))\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    ) % (str(REPO), str(manifest), str(base))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, check=True, cwd=tmp_path)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"')))
    assert "smmb_tpu_torch" in tops and "perfbench" in tops
    assert not tops & set(run.FORBIDDEN)


@pytest.mark.parametrize("name,caught", [("smmb_tpu_torch_probe.x", False),
                                         ("smmb_tpu.probe", True), ("jaxlib_probe", False)])
def test_forbidden_names_are_whole(monkeypatch, name, caught):
    before = set(run.forbidden_modules())
    monkeypatch.setitem(sys.modules, name, sys)
    assert (set(run.forbidden_modules()) - before == {name.split(".")[0]}) == caught


def test_no_card_no_result(tmp_path):
    """Without a card the command exits with code 3 and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, str(REPO / "perfbench" / "run.py"), "--workload",
                          "mlp4096.b256", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 3 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_cell_on_the_card():
    """The MLP cell once on the card, as the manifest's command runs it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "mlp4096.b256",
                          "--seed", "3", "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, timeout=900, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
