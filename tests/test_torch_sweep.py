"""Port parity: the reference-benchmark layer (smmb_tpu_torch.bench.report,
.sweep, .capacity, utils.config and io) against its smmb_tpu twins.

- The report and config layers give JAX's text for the same rows.
- ``_kernels_for_case`` on the CPU gives JAX's ``use_pallas=False`` row
  names, and each row's output equals JAX's at that row's tolerance
  (TOL_DENSE here: the CPU registry has no bf16 or W2A8 row) on the same
  numpy x, W and b.
- The benchmark entries validate every row on the CPU and time none (there is no
  card); the kernel rows appear only when asked for.
- ``io`` files load across the packages, both ways, for TCSC, BCSR,
  TernaryPacked, a packed MLP, master parameters and the test LM.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smmb_tpu import io as jio
from smmb_tpu.bench import report as jreport
from smmb_tpu.bench import sweep as jsweep
from smmb_tpu.formats import bcsr as jbcsr
from smmb_tpu.formats import packed as jpacked
from smmb_tpu.formats import tcsc as jtcsc
from smmb_tpu.models import lm as jlm
from smmb_tpu.models import mlp as jmlp
from smmb_tpu.utils import config as jconfig
from smmb_tpu_torch import convert
from smmb_tpu_torch import io as tio
from smmb_tpu_torch.bench import capacity as tcapacity
from smmb_tpu_torch.bench import report as treport
from smmb_tpu_torch.bench import sweep as tsweep
from smmb_tpu_torch.formats.bcsr import bcsr_from_dense
from smmb_tpu_torch.formats.packed import pack_ternary
from smmb_tpu_torch.formats.tcsc import tcsc_from_dense
from smmb_tpu_torch.models import lm as tlm
from smmb_tpu_torch.utils import rng
from smmb_tpu_torch.utils.compare import assert_close
from smmb_tpu_torch.utils.config import BenchConfig

torch.set_num_threads(2)
CPU = "cpu"

ROWS = [
    {"case": "1x512x2048@0.50", "kernel": "dense", "valid": True, "max_err": 0.0,
     "time_s": 4.76e-05, "flops": 2101248, "frac_roofline": 0.0264,
     "dispatch_bound": False},
    {"case": "1x512x2048@0.50", "kernel": "bcsr_kernel", "valid": True,
     "max_err": 1.62e-05, "time_s": 5.96e-05, "flops": 1050624,
     "frac_roofline": 0.00141, "dispatch_bound": False},
    {"case": "1x512x2048@0.50", "kernel": "tcsc_segsum", "valid": False,
     "max_err": math.inf, "time_s": math.nan, "flops": 1050624, "frac_roofline": 0.0,
     "dispatch_bound": True},
]


@pytest.mark.parametrize("columns", [None, ["case", "kernel", "valid", "time_s"]])
def test_report_text_equal_jax(tmp_path, columns):
    assert treport.results_table(ROWS, columns) == jreport.results_table(ROWS, columns)
    assert treport.results_table([]) == jreport.results_table([])
    for base in ("dense", "missing"):
        assert treport.speedup_analysis(ROWS, base) == jreport.speedup_analysis(ROWS, base)
    mean_rows = [{"case": "a", "kernel": "dense", "mean_s": 2.0},
                 {"case": "a", "kernel": "packed", "mean_s": 0.5}]
    assert "4.00x" in treport.speedup_analysis(mean_rows)
    path = tmp_path / "t.csv"
    text = treport.to_csv(ROWS, str(path))
    with open(path, newline="") as f:
        assert text == jreport.to_csv(ROWS) == f.read()
    assert treport.to_csv([]) == ""


def test_plot_is_optional(tmp_path):
    out = treport.plot_performance(ROWS, str(tmp_path / "p.png"))
    assert out is None or (tmp_path / "p.png").exists()


def test_progress_line(capsys):
    import sys

    p = treport.Progress(2, label="x", stream=sys.stdout)
    p.step()
    p.step()
    text = capsys.readouterr().out
    assert "x [" in text and "2/2" in text and text.endswith("\n")


@pytest.mark.parametrize("kw", [{}, {"ms": (1, 2), "iters": 3, "alpha": 0.25,
                                     "mesh_shapes": ((1, 2), (2, 2)), "kernels": ("dense",)}])
def test_bench_config_json_equal_jax(kw):
    t, j = BenchConfig(**kw), jconfig.BenchConfig(**kw)
    assert t.to_json() == j.to_json()
    assert BenchConfig.from_json(j.to_json()) == t
    assert dataclasses.asdict(jconfig.BenchConfig.from_json(t.to_json())) == dataclasses.asdict(t)
    assert t.cases() == j.cases()


def _case_inputs(seed, m, k, n, nz):
    rs = np.random.default_rng(seed)
    x = rs.uniform(-1, 1, (m, k)).astype(np.float32)
    p = 1.0 / (2 * nz)
    w = rs.choice(np.array([-1.0, 0.0, 1.0], np.float32), size=(k, n), p=[p, 1 - 2 * p, p])
    b = rs.uniform(-1, 1, (n,)).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("m,k,n,nz", [(4, 512, 256, 2), (3, 96, 80, 8)])
def test_kernels_for_case_rows_equal_jax(m, k, n, nz):
    x, w, b = _case_inputs(m + k, m, k, n, nz)
    jrows, jnnz = jsweep._kernels_for_case(jnp.asarray(x), w, jnp.asarray(b), False)
    trows, tnnz = tsweep._kernels_for_case(torch.from_numpy(x), w, torch.from_numpy(b), False)
    assert [r[0] for r in trows] == [r[0] for r in jrows] and tnnz == jnnz
    for (name, fn, args, work, wbytes), (_, jfn, jargs, jwork, jwbytes) in zip(trows, jrows):
        assert (work, wbytes) == (jwork, jwbytes), name
        want = np.array(jfn(*jargs))
        assert_close(fn(*args), want, tsweep.row_tolerance(name, torch.from_numpy(want)), name)


def test_kernels_for_case_filter_and_kernel_rows():
    x, w, b = _case_inputs(1, 2, 256, 256, 2)
    tx, tb = torch.from_numpy(x), torch.from_numpy(b)
    rows, _ = tsweep._kernels_for_case(tx, w, tb, True)
    names = [r[0] for r in rows]
    assert names[-1] == "bcsr_kernel" and "packed_kernel_w2a8_prelu" in names
    assert "bcsr_pallas" not in names
    only, _ = tsweep._kernels_for_case(tx, w, tb, True, kernel_filter=("bcsr_kernel", "dense"))
    assert [r[0] for r in only] == ["dense", "bcsr_kernel"]
    # K not a multiple of 128: no B2 row, as JAX has no bcsr_pallas row there
    x2, w2, b2 = _case_inputs(2, 2, 96, 256, 2)
    rows2, _ = tsweep._kernels_for_case(torch.from_numpy(x2), w2, torch.from_numpy(b2), True)
    assert "bcsr_kernel" not in [r[0] for r in rows2]


def test_run_case_validates_every_row_on_the_cpu(capsys):
    rows = tsweep.run_case(4, 256, 256, 2, reps=1, device=CPU, use_kernels=True)
    names = [r.kernel for r in rows]
    assert {"dense", "tcsc_segsum", "packed_jnp", "bcsr", "bcsr_kernel",
            "packed_kernel_bf16"} <= set(names)
    assert all(r.valid and r.max_err <= 0.03 * 64 for r in rows)
    assert all(math.isnan(r.time_s) for r in rows)  # no card, no time
    assert "MEASURE ERROR" in capsys.readouterr().err
    assert {r.case for r in rows} == {"4x256x256@0.50"}


def test_run_sweep_and_showcase_grids(monkeypatch):
    seen = []
    monkeypatch.setattr(tsweep, "run_case",
                        lambda m, k, n, non_zero, **kw: seen.append((m, k, n, non_zero, kw)) or [])
    tsweep.run_showcase()
    assert [s[:4] for s in seen] == [(*c, 2) for c in jsweep.SHOWCASE_CASES]
    seen.clear()
    tsweep.run_sweep(ms=[1], ks=[256], ns=[512, 1024])
    assert [s[:4] for s in seen] == [(1, 256, n, nz) for nz in jsweep.SWEEP_NON_ZERO
                                     for n in (512, 1024)]
    assert all(s[4]["alpha"] == jsweep.LEGACY_ALPHA for s in seen)
    assert (tsweep.SHOWCASE_CASES, tsweep.SWEEP_M, tsweep.SWEEP_K, tsweep.SWEEP_N,
            tsweep.SWEEP_NON_ZERO, tsweep.ALPHA, tsweep.DISPATCH_FLOOR_S) == (
        jsweep.SHOWCASE_CASES, jsweep.SWEEP_M, jsweep.SWEEP_K, jsweep.SWEEP_N,
        jsweep.SWEEP_NON_ZERO, jsweep.ALPHA, jsweep.DISPATCH_FLOOR_S)


def test_capacity_case_validates_on_the_cpu():
    rows = tcapacity.run_capacity_case(300, 512, 256, 2, bm=128, device=CPU)
    assert [r.kernel for r in rows] == ["packed_kernel_bf16", "dense_bf16"]
    assert all(r.valid and math.isnan(r.time_s) for r in rows)
    assert rows[0].case == "300x512x256@0.5"


# ------------------------------------------------------------------- io


def _ternary(seed, shape):
    return np.random.default_rng(seed).choice(np.array([-1.0, 0.0, 1.0], np.float32),
                                              size=shape)


def _same_fields(a, b):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, (int, float)):
            assert va == vb and type(va) is type(vb), f.name
        else:
            va = va.numpy() if isinstance(va, torch.Tensor) else np.asarray(va)
            vb = vb.numpy() if isinstance(vb, torch.Tensor) else np.asarray(vb)
            assert va.dtype == vb.dtype, f.name
            np.testing.assert_array_equal(va, vb)


@pytest.mark.parametrize("kind", ["TCSC", "BCSR", "TernaryPacked"])
def test_format_files_load_across_packages(tmp_path, kind):
    w = _ternary(3, (100, 256))
    jobj, tobj = {
        "TCSC": (jtcsc.tcsc_from_dense(w), tcsc_from_dense(w, device=CPU)),
        "BCSR": (jbcsr.bcsr_from_dense(w, 4, 128), bcsr_from_dense(w, 4, 128, device=CPU)),
        "TernaryPacked": (jpacked.pack_ternary(w), pack_ternary(w, device=CPU)),
    }[kind]
    jio.save(str(tmp_path / "j.npz"), jobj)
    tio.save(str(tmp_path / "t.npz"), tobj)
    _same_fields(tio.load(str(tmp_path / "j.npz"), device=CPU), tobj)
    _same_fields(jio.load(str(tmp_path / "t.npz")), jobj)
    a, b = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert sorted(a.files) == sorted(b.files)
    for f in a.files:
        np.testing.assert_array_equal(a[f], b[f])


def test_packed_mlp_and_params_files_load_across_packages(tmp_path):
    cfg = jmlp.TernaryMLPConfig(layer_dims=(64, 128, 32))
    params = jmlp.init_mlp(jax.random.PRNGKey(0), cfg)
    jp = jmlp.pack_mlp(params, quantize=True)
    jio.save_packed_mlp(str(tmp_path / "j.npz"), jp)
    got = tio.load_packed_mlp(str(tmp_path / "j.npz"), device=CPU)
    want = convert.packed_mlp_from_jax(jp, device=CPU)
    for g, w_ in zip(got["w"], want["w"]):
        assert torch.equal(g.data, w_.data) and (g.rows, g.cols, g.nnz) == (w_.rows, w_.cols, w_.nnz)
    for key in ("b", "scale"):
        for g, w_ in zip(got[key], want[key]):
            assert torch.equal(g, w_.reshape(g.shape))
    tio.save_packed_mlp(str(tmp_path / "t.npz"), got)
    back = jio.load_packed_mlp(str(tmp_path / "t.npz"))
    for g, w_ in zip(back["w"], jp["w"]):
        np.testing.assert_array_equal(np.asarray(g.data), np.asarray(w_.data))
        assert (g.rows, g.cols, g.nnz) == (w_.rows, w_.cols, w_.nnz)

    tparams = convert.mlp_params_from_jax(jax.tree.map(np.asarray, params), device=CPU)
    tio.save_params(str(tmp_path / "tp.npz"), tparams)
    jback = jio.load_params(str(tmp_path / "tp.npz"))
    jio.save_params(str(tmp_path / "jp.npz"), params)
    tback = tio.load_params(str(tmp_path / "jp.npz"), device=CPU)
    for i in range(cfg.num_layers):
        for key in ("w", "b"):
            np.testing.assert_array_equal(np.asarray(jback[key][i]), np.asarray(params[key][i]))
            np.testing.assert_array_equal(tback[key][i].numpy(), np.asarray(params[key][i]))


def _leaf_arrays(tree):
    return [np.asarray(v) for v in jax.tree.leaves(tree)]


def test_lm_pytree_files_load_across_packages(tmp_path):
    kw = dict(vocab=128, d_model=128, n_heads=2, d_ff=256, n_layers=2, max_len=16)
    jpacked_lm = jlm.pack_lm(jlm.init_lm(jax.random.PRNGKey(0), jlm.TernaryLMConfig(**kw)))
    template = tlm.pack_lm(tlm.init_lm(rng.make_generator(99, CPU), tlm.TernaryLMConfig(**kw)))
    jio.save_pytree(str(tmp_path / "j.npz"), jpacked_lm)
    got = tio.load_pytree(str(tmp_path / "j.npz"), template, device=CPU)
    want = convert.packed_lm_from_jax(jpacked_lm, device=CPU)
    assert tio._leaves(got).__len__() == len(jax.tree.leaves(jpacked_lm))
    for g, w_ in zip(tio._leaves(got), tio._leaves(want)):
        np.testing.assert_array_equal(g.numpy(), w_.numpy().reshape(g.shape))
    assert got["head"].rows == template["head"].rows and set(got) == set(template)
    # and back: the port's file loads into a JAX template
    tio.save_pytree(str(tmp_path / "t.npz"), got)
    jtemplate = jlm.pack_lm(jlm.init_lm(jax.random.PRNGKey(9), jlm.TernaryLMConfig(**kw)))
    back = jio.load_pytree(str(tmp_path / "t.npz"), jtemplate)
    for a, b in zip(_leaf_arrays(back), _leaf_arrays(jpacked_lm)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tio.load_pytree(str(tmp_path / "j.npz"), {"only": torch.zeros(2)}, device=CPU)


def test_io_rejects_unknown_format(tmp_path):
    with pytest.raises(TypeError):
        tio.save(str(tmp_path / "x.npz"), object())
