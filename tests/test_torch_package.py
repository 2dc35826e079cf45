"""The port as a package: it imports neither JAX nor smmb_tpu, its entry
points run on the CUDA card by default and raise without one, CPU calls
count no kernel launch, and chip_smoke.py fails without a card."""

import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from smmb_tpu_torch import convert
from smmb_tpu_torch import io as tio
from smmb_tpu_torch.bench import autotune, mlp_bench
from smmb_tpu_torch.bench import sweep as tsweep
from smmb_tpu_torch.formats import bcsr as tbcsr
from smmb_tpu_torch.formats import packed as tpacked
from smmb_tpu_torch.formats import tcsc as ttcsc
from smmb_tpu_torch.kernels import _build
from smmb_tpu_torch.kernels import bcsr_spmm as tbk
from smmb_tpu_torch.models import mlp as tmlp
from smmb_tpu_torch.nn import PackedTernaryDense
from smmb_tpu_torch.utils import rng
from smmb_tpu_torch.utils.device import resolve_device

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent


def _run(code: str, cwd=ROOT, timeout=120) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=timeout,
    )


def test_imports_no_jax_and_no_smmb_tpu():
    r = _run("""
        import importlib, pkgutil, sys
        import torch
        torch.set_num_threads(1)
        import smmb_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            smmb_tpu_torch.__path__, "smmb_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "smmb_tpu", "flax"))
        assert not bad, bad
        # CPU calls run the plain versions and count no kernel launch
        from smmb_tpu_torch.kernels.packed_spmm import packed_spmm
        from smmb_tpu_torch.models import mlp
        from smmb_tpu_torch.utils import rng
        gen = rng.make_generator(0, "cpu")
        cfg = mlp.TernaryMLPConfig(layer_dims=(64, 96, 32))
        packed = mlp.pack_mlp(mlp.init_mlp(gen, cfg))
        for cdt in (torch.float32, torch.bfloat16, torch.int8):
            y = mlp.mlp_forward(packed, rng.rand_dense(gen, (4, 64)), cfg,
                                compute_dtype=cdt)
            assert y.shape == (4, 32)
        assert packed_spmm.launches == 0, packed_spmm.launches
        from smmb_tpu_torch.bench.sweep import run_case
        from smmb_tpu_torch.kernels.bcsr_spmm import bcsr_spmm_kernel
        rows = run_case(2, 128, 128, 2, reps=1, device="cpu", use_kernels=True)
        assert "bcsr_kernel" in [r.kernel for r in rows] and all(r.valid for r in rows)
        assert bcsr_spmm_kernel.launches == 0 and packed_spmm.launches == 0
        print("modules", len(names))
    """)
    assert r.returncode == 0, r.stderr[-2000:]
    assert int(r.stdout.split()[-1]) >= 43


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device(no_cuda):
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")


@pytest.mark.parametrize(
    "entry",
    [
        lambda: rng.make_generator(0),
        lambda: tpacked.pack_ternary(np.ones((4, 4), np.float32)),
        lambda: PackedTernaryDense(16, 8),
        lambda: convert.mlp_params_from_jax(
            {"w": [np.ones((2, 2), np.float32)], "b": [np.zeros(2, np.float32)]}),
        lambda: mlp_bench.run_mlp_bench(1, 64, 4, reps=1),
        lambda: ttcsc.tcsc_from_dense(np.eye(4, dtype=np.float32)),
        lambda: tbk.bcsr_prepare(tbcsr.bcsr_from_dense(np.eye(8, 128, dtype=np.float32),
                                                       8, 128, device="cpu")),
        lambda: tsweep.run_case(1, 128, 128, 2, reps=1),
        lambda: tio.load("no_such_file.npz"),
        lambda: autotune.autotune_packed_spmm(4, 512, 256, use_cache=False),
    ],
    ids=["make_generator", "pack_ternary", "PackedTernaryDense",
         "mlp_params_from_jax", "run_mlp_bench", "tcsc_from_dense", "bcsr_prepare",
         "run_case", "io_load", "autotune_packed_spmm"],
)
def test_entry_points_default_to_the_card(no_cuda, entry):
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    r = _run("import runpy; runpy.run_path('chip_smoke.py', run_name='__main__')")
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run("import runpy; runpy.run_path('chip_smoke.py', run_name='__main__')",
             cwd=tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_build_library_name_follows_the_source(tmp_path, monkeypatch):
    src = "packed_spmm.cu"
    lib = _build.library_path(src)
    assert lib.parent == _build.BUILD_DIR and lib == _build.library_path(src)
    assert lib.name.startswith("libpacked_spmm_") and lib.suffix == ".so"
    assert "smmb_tpu_torch/_build/" in (ROOT / ".gitignore").read_text()
    # an edited source gets another library name, so it is rebuilt
    (tmp_path / src).write_bytes((_build.CSRC / src).read_bytes() + b"\n// edit\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build.library_path(src) != lib
    assert set(_build.SOURCES) == {p.name for p in (ROOT / "smmb_tpu_torch/kernels/csrc").glob("*.cu")}


def test_nvcc_missing_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc_path()


def test_cpu_mlp_module_counts_no_launch():
    from smmb_tpu_torch.kernels.packed_spmm import packed_spmm

    cfg = tmlp.TernaryMLPConfig(layer_dims=(64, 128, 64))
    packed = tmlp.pack_mlp(tmlp.init_mlp(rng.make_generator(3, "cpu"), cfg))
    before = packed_spmm.launches
    module = tmlp.PackedTernaryMLP(packed, cfg, compute_dtype=torch.bfloat16)
    y = module(torch.ones(2, 64))
    assert y.shape == (2, 64) and packed_spmm.launches == before
