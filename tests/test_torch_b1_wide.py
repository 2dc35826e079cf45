"""B1's wide bf16 body (``WIDE_TILE``, 128×256: ``packed_spmm_mma_wg`` on
the warpgroup MMA, fed by TMA): the rule that routes calls to it, its tile
in ``check_tile``, its kernel's name in the benchmark's kernel groups (CPU
tests), and on the card the body against the plain version at the LM
prefill's shapes, its rows bitwise the M = 1 calls and the 64×128 tile's,
and its launch counter.

The card tests skip without a CUDA device. This file imports neither JAX
nor smmb_tpu, so on the card it runs as
``python -m pytest --noconftest -q tests/test_torch_b1_wide.py``.

Tolerance: bf16 2^-7 relative to max(1, max|Y|), as chip_smoke.py's phase 3
(X and Y in bf16: the f32 sums agree to ~1e-6, so rounding Y to bf16
differs by at most one bf16 ulp from the plain product's).
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from smmb_tpu_torch.bench import autotune
from smmb_tpu_torch.formats.packed import pack_ternary, pack_ternary_device
from smmb_tpu_torch.kernels.packed_spmm import (
    MMA_TILES,
    WIDE_MIN_BLOCKS,
    WIDE_TILE,
    check_tile,
    packed_spmm,
    packed_spmm_plain,
    tile_for,
    tiles_of,
)

ROOT = Path(__file__).resolve().parent.parent
ALPHA = 0.2
BF16 = torch.bfloat16
# the LM prefill's B1 calls (ternary-lm-2b): (K, N) of the fused QKV, the K
# and V projections, the MLP's up and down projections and the head
PREFILL_KN = ((2560, 2560), (2560, 640), (2560, 6912), (6912, 2560), (2560, 128256))


@pytest.mark.parametrize("m,n,wide", [
    (4096, 2560, True), (8192, 2560, True), (16384, 2560, True),  # lm2b.prefill-mix
    (4096, 6912, True), (16384, 6912, True), (4096, 128256, True), (16384, 128256, True),
    (8192, 640, True), (16384, 640, True),
    (4096, 640, True),  # 32 x 3 wide blocks
    (1024, 640, False),  # 8 x 3: the small tiles' many blocks finish first
    (65536, 2560, True), (65536, 128256, True),  # lm2b.decode-b64's batch prefill
    (64, 2560, False), (64, 128256, False),  # its decode steps: M under 128 rows
    (256, 4096, False),  # mlp4096.b256: 2 x 16 wide blocks
    (127, 128256, False), (128, 10240, True), (128, 9984, False),  # the edges
])
def test_tile_for_routes_by_shape(m, n, wide):
    bm, bn, _ = tile_for(m, n, BF16)
    assert ((bm, bn) == WIDE_TILE) == wide
    if wide:
        assert m >= WIDE_TILE[0] and -(-m // bm) * -(-n // bn) >= WIDE_MIN_BLOCKS
    else:
        assert (bm, bn) in MMA_TILES


@pytest.mark.parametrize("cdt", [torch.float32, torch.int8])
def test_tile_for_keeps_the_other_modes(cdt):
    """The f32 and W2A8 modes and unaligned bf16 rows never take it."""
    for m, n in ((16384, 6912), (65536, 128256), (4096, 2560)):
        assert tile_for(m, n, cdt)[:2] != WIDE_TILE
        assert tile_for(m, n, BF16, aligned=False)[:2] in MMA_TILES


@pytest.mark.parametrize("kw,want", [
    (dict(block_m=128, block_n=256), WIDE_TILE),
    (dict(block_m=128), WIDE_TILE),
    (dict(block_n=256), WIDE_TILE),
    (dict(block_m=64, block_n=128), (64, 128)),
    (dict(block_m=16), (16, None)),
])
def test_check_tile_takes_the_wide_tile_in_bf16(kw, want):
    assert check_tile(kw.get("block_m"), kw.get("block_n"), BF16) == want


@pytest.mark.parametrize("cdt,kw", [
    (BF16, dict(block_m=128, block_n=64)), (BF16, dict(block_m=64, block_n=256)),
    (BF16, dict(block_m=256, block_n=128)), (torch.int8, dict(block_m=128, block_n=256)),
    (torch.int8, dict(block_n=256)), (torch.float32, dict(block_m=128)),
])
def test_check_tile_refuses_what_a_mode_lacks(cdt, kw):
    with pytest.raises(ValueError, match="its tiles"):
        check_tile(kw.get("block_m"), kw.get("block_n"), cdt)


def test_tiles_of_each_mode():
    assert tiles_of(BF16) == MMA_TILES + (WIDE_TILE,)
    assert WIDE_TILE not in tiles_of(torch.int8) and WIDE_TILE not in tiles_of(torch.float32)
    cands = autotune.default_candidates(4096, BF16)
    assert {"block_m": 128, "block_n": 256} in cands


def test_wide_tile_on_the_cpu_route_is_the_plain_output():
    rs = np.random.default_rng(3)
    x = torch.from_numpy(rs.uniform(-1, 1, (130, 512)).astype(np.float32))
    w = pack_ternary(rs.choice(np.array([-1.0, 0.0, 1.0], np.float32), size=(512, 256)),
                     device="cpu")
    want = packed_spmm(x, w, None, ALPHA, compute_dtype=BF16)
    wide = packed_spmm.launches_wide
    for kw in (dict(block_m=128), dict(block_n=256), dict(block_m=128, block_n=256)):
        assert torch.equal(packed_spmm(x, w, None, ALPHA, compute_dtype=BF16, **kw), want)
    assert packed_spmm.launches_wide == wide  # the CPU runs no kernel


def _global_names(source: str) -> list:
    """The ``__global__`` functions' names in a CUDA source."""
    names = []
    for hit in re.finditer(r"__global__\s+void\s+", source):
        rest = source[hit.end():]
        if rest.startswith("__launch_bounds__"):
            depth, i = 0, len("__launch_bounds__")
            while True:
                depth += {"(": 1, ")": -1}.get(rest[i], 0)
                i += 1
                if depth == 0:
                    break
            rest = rest[i:]
        names.append(re.match(r"\s*(\w+)", rest)[1])
    return names


def test_every_b1_kernel_counts_as_a_ternary_projection():
    """``spmm_roofline.*`` reads the device time of the kernels whose names
    hold a string of ``perfbench/counts/kernels/*.json``'s
    ``ternary_projections``: every body of B1 is among them. B1g
    (``expert_spmm_grouped``, the routed experts in one launch) is read by
    ``expert_roofline.*`` through ``routed_experts`` and is no projection."""
    groups = {}
    for path in sorted((ROOT / "perfbench/counts/kernels").glob("*.json")):
        for key, value in json.loads(path.read_text()).items():
            if isinstance(value, list):
                groups.setdefault(key, []).extend(value)
    names = _global_names(
        (ROOT / "smmb_tpu_torch/kernels/csrc/packed_spmm.cu").read_text())
    assert {"packed_spmm_float", "packed_spmm_mma", "packed_spmm_mma_wg",
            "expert_spmm_grouped"} <= set(names)
    for name in names:
        projection = any(s in name for s in groups["ternary_projections"])
        if name == "expert_spmm_grouped":
            assert not projection and any(s in name for s in groups["routed_experts"])
        else:
            assert projection, name


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _setup(seed, m, k, n, dev, bias=True):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.rand(m, k, generator=gen, device=dev) * 2 - 1).to(BF16)
    w = torch.randint(-1, 2, (k, n), generator=gen, device=dev).float()
    b = torch.rand(n, generator=gen, device=dev) * 2 - 1 if bias else None
    return x, pack_ternary_device(w), b


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", PREFILL_KN)
@pytest.mark.parametrize("m,bias", [(4097, True), (4096, False)])
def test_wide_body_matches_plain(cuda, m, k, n, bias):
    x, p, b = _setup(7 + n, m, k, n, cuda, bias)
    alpha = ALPHA if bias else None
    before, wide = packed_spmm.launches, packed_spmm.launches_wide
    y = packed_spmm(x, p, b, alpha, compute_dtype=BF16, block_m=128, block_n=256)
    assert packed_spmm.launches == before + 1 and packed_spmm.launches_wide == wide + 1
    ref = packed_spmm_plain(x, p, b, alpha, compute_dtype=BF16).float()
    torch.cuda.synchronize()
    assert y.shape == (m, n) and y.dtype == BF16
    err = float((y.float() - ref).abs().max())
    assert err <= 2.0 ** -7 * max(1.0, float(ref.abs().max())), err


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(2560, 6912), (6912, 2560)])
def test_wide_rows_equal_the_m1_and_small_tile_calls(cuda, k, n):
    """Rows of an M = 8,192 call on the wide body are bitwise the M = 1
    calls and the same call forced onto the 64×128 tile (f32 output, so
    every bit of the sums shows)."""
    x, p, b = _setup(11, 8192, k, n, cuda)
    x32 = x.float()
    assert tile_for(8192, n, BF16)[:2] == WIDE_TILE
    y = packed_spmm(x32, p, b, ALPHA, compute_dtype=BF16)
    small = packed_spmm(x32, p, b, ALPHA, compute_dtype=BF16, block_m=64, block_n=128)
    torch.cuda.synchronize()
    assert torch.equal(y, small)
    rows = (0, 1, 127, 128, 4095, 4100, 8191)
    ones = torch.cat([packed_spmm(x32[r:r + 1], p, b, ALPHA, compute_dtype=BF16)
                      for r in rows])
    torch.cuda.synchronize()
    assert torch.equal(y[list(rows)], ones)


@pytest.mark.cuda
def test_launches_wide_counts_the_routed_calls(cuda):
    x, p, _ = _setup(13, 8192, 2560, 2560, cuda, bias=False)
    xs, ps, _ = _setup(14, 256, 4096, 4096, cuda, bias=False)
    before, wide = packed_spmm.launches, packed_spmm.launches_wide
    packed_spmm(x, p, compute_dtype=BF16)  # 64 x 10 wide blocks: routed
    packed_spmm(xs, ps, compute_dtype=BF16)  # the MLP cell's shape: 64x128
    packed_spmm(x, p, compute_dtype=torch.int8)  # W2A8: never
    packed_spmm(x[:64], p, compute_dtype=BF16)  # under 128 rows
    torch.cuda.synchronize()
    assert packed_spmm.launches == before + 4 and packed_spmm.launches_wide == wide + 1


@pytest.mark.cuda
def test_wide_tile_refuses_unaligned_rows(cuda):
    x, p, _ = _setup(15, 300, 1001, 256, cuda, bias=False)  # K not a multiple of 8
    with pytest.raises(ValueError, match="TMA"):
        packed_spmm(x, p, compute_dtype=BF16, block_m=128)
    y = packed_spmm(x, p, compute_dtype=BF16)  # the rule keeps it off the wide body
    ref = packed_spmm_plain(x, p, compute_dtype=BF16).float()
    torch.cuda.synchronize()
    assert float((y.float() - ref).abs().max()) <= 2.0 ** -7 * max(1.0, float(ref.abs().max()))
