"""Port parity: B1's tile override (smmb_tpu_torch.kernels.packed_spmm) and
the tile autotuner (smmb_tpu_torch.bench.autotune), the twin of
tests/test_aux.py's ``test_autotune_cache``.

On the CPU the wrapper checks the tile, then runs the plain version, so
every legal tile gives the same output bitwise (on the card every tile walks
K in the same order: tests/test_torch_cuda.py holds that there); a tile the
kernel lacks raises. The autotuner on ``device="cpu"`` times its candidates
by the host's clock and writes the same cache as on the card; without a
card, ``device=None`` raises. JAX's packed SpMM (interpret mode) holds the
port's output at the tolerances of tests/test_torch_packed_spmm.py.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smmb_tpu.formats.packed import pack_ternary as jpack
from smmb_tpu.kernels import packed_spmm as jspmm
from smmb_tpu_torch.bench import autotune
from smmb_tpu_torch.formats.packed import pack_ternary
from smmb_tpu_torch.kernels.packed_spmm import F32_TILES, MMA_TILES, packed_spmm
from smmb_tpu_torch.utils.compare import TOL_DENSE, assert_close

torch.set_num_threads(2)
ALPHA = 0.2
MODES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
JAX_MODES = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}
JAX_TOL = {"f32": TOL_DENSE, "bf16": 0.2}  # int8: 1e-5 of max|Y|, as the W2A8 twin


def _setup(seed, m, k, n):
    rs = np.random.default_rng(seed)
    x = rs.uniform(-1, 1, (m, k)).astype(np.float32)
    w = rs.choice(np.array([-1.0, 0.0, 1.0], np.float32), size=(k, n))
    b = rs.uniform(-1, 1, (n,)).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("m,k,n", [(5, 1024, 640), (33, 512, 256)])
def test_every_tile_gives_the_same_output(mode, m, k, n):
    x, w, b = _setup(3 + m, m, k, n)
    tx, tp, tb = torch.from_numpy(x), pack_ternary(w, device="cpu"), torch.from_numpy(b)
    cdt = MODES[mode]
    want = packed_spmm(tx, tp, tb, ALPHA, compute_dtype=cdt)
    kws = [dict(block_m=bm, block_n=bn) for bm, bn in MMA_TILES]
    kws += [dict(block_m=64), dict(block_n=64)]
    for kw in kws:
        assert torch.equal(packed_spmm(tx, tp, tb, ALPHA, compute_dtype=cdt, **kw), want), kw
    ref = np.asarray(jspmm(jnp.asarray(x), jpack(w), jnp.asarray(b), alpha=ALPHA,
                           compute_dtype=JAX_MODES[mode], block_m=32, block_n=256))
    tol = JAX_TOL.get(mode, 1e-5 * float(np.abs(ref).max()))
    assert_close(want, ref, tol, f"{mode} vs JAX")


def test_f32_takes_its_one_tile():
    """The f32 mode takes every tile of ``F32_TILES`` (and one side named,
    the other ``tile_for``'s), each bitwise the default output on the CPU
    route: the f32 body has four tiles and one K walk."""
    x, w, b = _setup(9, 8, 512, 256)
    tx, tp, tb = torch.from_numpy(x), pack_ternary(w, device="cpu"), torch.from_numpy(b)
    want = packed_spmm(tx, tp, tb, ALPHA)
    kws = [dict(block_m=bm, block_n=bn) for bm, bn in F32_TILES]
    for kw in kws + [dict(block_m=64), dict(block_n=128), dict(block_m=16)]:
        assert torch.equal(packed_spmm(tx, tp, tb, ALPHA, **kw), want), kw


@pytest.mark.parametrize("mode,kw", [
    ("bf16", dict(block_m=32, block_n=256)),  # JAX's TPU tile
    ("bf16", dict(block_m=16, block_n=256)),
    ("int8", dict(block_m=128)),
    ("int8", dict(block_n=32)),
    ("f32", dict(block_m=32, block_n=256)),  # JAX's TPU tile
    ("f32", dict(block_m=128)),
    ("f32", dict(block_n=32)),
])
def test_a_tile_the_kernel_lacks_raises(mode, kw):
    x, w, _ = _setup(10, 4, 512, 256)
    tx, tp = torch.from_numpy(x), pack_ternary(w, device="cpu")
    tiles = ("64x128, 64x64, 16x128, 16x64" if mode == "f32"
             else "16x64, 16x128, 64x64, 64x128")
    with pytest.raises(ValueError, match=tiles):
        packed_spmm(tx, tp, compute_dtype=MODES[mode], **kw)
    with pytest.raises(ValueError):  # 3-D x is checked the same way
        packed_spmm(tx.reshape(2, 2, 512), tp, compute_dtype=MODES[mode], **kw)


@pytest.mark.parametrize("mode,count", [("bf16", 5), ("int8", 4), ("f32", 4)])
def test_default_candidates(mode, count):
    cands = autotune.default_candidates(256, MODES[mode])
    assert len(cands) == count
    assert all(set(c) == {"block_m", "block_n"} for c in cands)
    x, w, _ = _setup(11, 4, 512, 256)
    tx, tp = torch.from_numpy(x), pack_ternary(w, device="cpu")
    want = packed_spmm(tx, tp, compute_dtype=MODES[mode])
    for c in cands:  # every candidate is a tile the wrapper takes
        assert torch.equal(packed_spmm(tx, tp, compute_dtype=MODES[mode], **c), want)


def test_autotune_cache(tmp_path, monkeypatch):
    path = tmp_path / "cache.json"
    monkeypatch.setattr(autotune, "CACHE_PATH", str(path))
    cfg = autotune.autotune_packed_spmm(
        4, 512, 256, torch.float32, candidates=[{"block_m": 64, "block_n": 128}],
        reps=2, device="cpu")
    assert cfg == {"block_m": 64, "block_n": 128}
    cache = json.loads(path.read_text())
    assert list(cache) == ["cpu|4x512x256|float32"]
    assert cache["cpu|4x512x256|float32"]["config"] == cfg
    assert cache["cpu|4x512x256|float32"]["time_us"] > 0

    def no_timer(*a, **k):
        raise AssertionError("measured on a cached key")

    # the second call hits the cache (no measurement)
    monkeypatch.setattr(autotune, "measure_host", no_timer)
    assert autotune.autotune_packed_spmm(4, 512, 256, torch.float32, device="cpu") == cfg


def test_autotune_picks_among_the_tiles_it_can_run(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(autotune, "CACHE_PATH", str(tmp_path / "cache.json"))
    cands = [{"block_m": 32, "block_n": 256}, {"block_m": 16, "block_n": 64},
             {"block_m": 64, "block_n": 128}]
    cfg = autotune.autotune_packed_spmm(8, 512, 256, torch.bfloat16, candidates=cands,
                                        reps=1, use_cache=False, verbose=True, device="cpu")
    assert cfg in cands[1:]
    out = capsys.readouterr().out
    assert '{"block_m": 32, "block_n": 256}: refused' in out
    assert out.count(" us") == 2
    with pytest.raises(RuntimeError, match="no candidate"):
        autotune.autotune_packed_spmm(8, 512, 256, torch.bfloat16, candidates=cands[:1],
                                      reps=1, use_cache=False, device="cpu")


def test_autotune_needs_a_card_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(autotune, "CACHE_PATH", str(tmp_path / "cache.json"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        autotune.autotune_packed_spmm(4, 512, 256)
    with pytest.raises(RuntimeError, match="CUDA"):
        autotune.main(["4", "512", "256", "--dtype", "int8"])
    assert not (tmp_path / "cache.json").exists()
