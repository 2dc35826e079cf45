"""B9's CUDA-core body's tiles (smmb_tpu_torch.kernels.flash_attention): the
kv tile frozen at the first port's rule (it sets where the online softmax
rescales, so it is part of the output bits), the body each call takes, the
row tile the wrapper picks and the block's shared memory at every width
the body accepts, and the CPU dispatch (the plain version) against JAX's
``flash_attention``.

The kernel runs only on the card (tests/test_torch_cuda.py holds it bitwise
across row tiles and against the plain version there); these tests hold the
Python side that chooses its launch, and the C source's copies of the same
rules. Tolerances as tests/test_torch_flash.py's (JAX's tests/test_flash.py:
f32 1e-5, bf16 0.05).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smmb_tpu.kernels import flash_attention as jfa
from smmb_tpu_torch.kernels import flash_attention as tfa

torch.set_num_threads(2)

F32, BF16 = torch.float32, torch.bfloat16
MAX_SMEM = 232448
SOURCE = (Path(tfa.__file__).parent / "csrc" / "flash_attention.cu").read_text()


def frozen_tile(hd: int, pipeline_p: bool):
    """The first port's kv tile (serial, pipelined), None where refused."""
    for top, serial, pipe in ((193, 64, 64), (209, 64, 32), (436, 32, 32), (444, 32, 16),
                              (898, 16, 16), (902, 16, None)):
        if hd <= top:
            return pipe if pipeline_p else serial
    return None


@pytest.mark.parametrize("pipeline_p", [False, True], ids=["serial", "pipe"])
@pytest.mark.parametrize("hd", [64, 128, 193, 194, 209, 210, 256, 436, 437, 444, 445, 512,
                                898, 899, 902, 903])
def test_kv_tile_frozen_at_the_boundaries(hd, pipeline_p):
    want = frozen_tile(hd, pipeline_p)
    if want is None:
        with pytest.raises(ValueError, match="too wide"):
            tfa.kernel_tile(hd, pipeline_p)
    else:
        assert tfa.kernel_tile(hd, pipeline_p) == want


def test_kv_tile_frozen_at_every_width():
    """kernel_tile is the table at every hd up to 910, and still the first
    port's shared-memory rule (not the new block's)."""
    for hd in range(1, 911):
        for pipe in (False, True):
            want = frozen_tile(hd, pipe)
            got = None
            try:
                got = tfa.kernel_tile(hd, pipe)
            except ValueError:
                pass
            assert got == want, (hd, pipe)
    assert tfa.shared_bytes(64, 128) == 148992  # the first port's block at hd 128
    assert tfa.shared_bytes_pipe(64, 128) == 165632


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_kernel_route_unchanged(dtype):
    """bf16 at hd 64 and 128 takes the mma body, every other call the
    CUDA-core body at the frozen tile, under both schedules."""
    for hd in range(1, 903):
        for pipe in (False, True):
            if frozen_tile(hd, pipe) is None:
                continue
            want = ("mma", 64) if dtype == BF16 and hd in (64, 128) else \
                ("cuda_core", frozen_tile(hd, pipe))
            assert tfa.kernel_route(dtype, hd, pipe) == want, (hd, pipe)


def _dv(dtype, hd):
    ve = 16 // (4 if dtype == F32 else 2)
    need, dv = -(-(-(-hd // ve)) // 16), 1
    while dv < need:
        dv *= 2
    return ve, dv


@pytest.mark.parametrize("pipeline_p", [False, True], ids=["serial", "pipe"])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_core_rows_fit_every_width(dtype, pipeline_p):
    """At every hd the body accepts, the row tiles it takes include 16, keep
    the accumulator within 64 registers a thread and fit the block's shared
    memory (two K slots, one only serial where two do not fit)."""
    one_slot = []
    for hd in range(1, 903):
        tile = frozen_tile(hd, pipeline_p)
        if tile is None:
            continue
        rows = tfa.core_rows(dtype, hd, pipeline_p)
        assert rows and rows[-1] == 16 and list(rows) == sorted(rows, reverse=True)
        assert set(rows) <= set(tfa.CORE_ROWS)
        ve, dv = _dv(dtype, hd)
        for r in rows:
            assert (r // 16) * dv * ve <= 64
            slots = tfa.core_k_slots(dtype, hd, r, tile, pipeline_p)
            assert tfa.core_shared_bytes(dtype, hd, r, tile, slots) <= MAX_SMEM
            if slots == 1:
                assert tfa.core_shared_bytes(dtype, hd, r, tile, 2) > MAX_SMEM
                one_slot.append((hd, r))
    if pipeline_p:
        assert one_slot == []
    elif dtype == F32:
        assert (901, 16) in one_slot and (902, 16) in one_slot


def test_core_shared_bytes_match_the_source():
    """The wrapper's account of the block agrees with csrc's, and with the
    sums worked by hand: f32 hd 128 at 128 rows (Q 67,840, two K slots
    67,584, V 32,768, p 33,024 bytes), and f32 hd 902 at 16 rows, which
    fits only with one K slot."""
    assert tfa.core_shared_bytes(F32, 128, 128, 64) == 201216
    assert tfa.core_shared_bytes(F32, 902, 16, 16, 2) == 233728 > MAX_SMEM
    assert tfa.core_shared_bytes(F32, 902, 16, 16, 1) == 175616
    # bf16 hd 256: Q as f32 rows of 65 vectors, K and V rows of 32 bf16
    # vectors (33 in K)
    assert tfa.core_shared_bytes(BF16, 256, 64, 32) == 4 * (64 * 260 + 64) + \
        16 * (2 * 32 * 33 + 32 * 32) + 4 * (64 * 32 + 64)
    assert ("4 * (rows * lq + 64) + 16 * (kslots * bt * (nv | 1) + bt * nv) + "
            "4 * (rows * bt + 64)") in SOURCE
    assert "SRMAX = 64 / (DV * (16 / int(sizeof(T))))" in SOURCE
    assert "if (smem > MAX_SMEM && !PIPE) smem = core_smem(" in SOURCE


@pytest.mark.parametrize("rows,b,h,kvh,t,want", [
    (128, 1, 8, 8, 4096, 256), (16, 1, 8, 8, 32, 16), (128, 1, 8, 8, 32, 8),
    (64, 1, 8, 2, 200, 26),  # g = 4: 4 heads a block, 16 tokens
    (64, 1, 6, 2, 100, 10),  # g = 3: 3 heads a block, 21 tokens
    (32, 2, 8, 8, 512, 256), (16, 1, 2, 2, 100, 14),
])
def test_core_blocks(rows, b, h, kvh, t, want):
    assert tfa.core_blocks(rows, b, h, kvh, t) == want


@pytest.mark.parametrize("dtype,hd,b,h,kvh,t,pipe,want", [
    (F32, 128, 1, 8, 8, 4096, False, 128),  # the long prefill: 256 blocks
    (F32, 128, 1, 8, 8, 32, False, 16),  # the LM's prefill: 16 blocks
    (F32, 128, 1, 8, 8, 512, False, 16),
    (F32, 128, 1, 8, 8, 512, True, 16),
    (F32, 128, 4, 8, 8, 4096, False, 128),
    (F32, 200, 1, 4, 4, 512, True, 16),
    (F32, 902, 1, 2, 2, 100, False, 16),
    (BF16, 256, 1, 4, 4, 512, False, 16),
    (BF16, 256, 1, 32, 32, 4096, False, 64),
    (BF16, 512, 1, 2, 2, 256, True, 16),
], ids=str)
def test_row_tile_picks(dtype, hd, b, h, kvh, t, pipe, want):
    """The widest row tile whose launch has at least one block an SM (132),
    else the narrowest; always one the body takes."""
    got = tfa.row_tile(dtype, hd, b, h, kvh, t, pipe)
    assert got == want and got in tfa.core_rows(dtype, hd, pipe)
    wider = [r for r in tfa.core_rows(dtype, hd, pipe) if r > got]
    assert all(tfa.core_blocks(r, b, h, kvh, t) < tfa.SMS for r in wider)


def _qkv(seed, b, h, kvh, t, hd):
    rs = np.random.default_rng(seed)
    return (rs.standard_normal((b, h, t, hd)).astype(np.float32) * 2.0,
            rs.standard_normal((b, kvh, t, hd)).astype(np.float32),
            rs.standard_normal((b, kvh, t, hd)).astype(np.float32))


@pytest.mark.parametrize("b,h,kvh,t,hd,window", [
    (1, 2, 2, 70, 256, None),  # the 32-column tile
    (1, 4, 2, 100, 200, 40),  # GQA, a window, hd 200
    (1, 2, 1, 40, 512, None),  # the 16-column tile
])
def test_cpu_dispatch_is_the_plain_version_and_matches_jax(b, h, kvh, t, hd, window):
    """A CPU tensor runs the plain version (a forced row tile changes
    nothing and counts no launch), at the kernel's kv tile within JAX's
    f32 tolerance of JAX's flash_attention; bf16 within 0.05."""
    q, k, v = _qkv(t + hd, b, h, kvh, t, hd)
    want = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          window=window))
    tile = tfa.kernel_tile(hd)
    before = (tfa.flash_attention.launches, tfa.flash_attention.pipe_launches)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tfa.flash_attention(tq, tk, tv, window=window, block_kv=tile, _rows=16)
    plain = tfa.flash_attention_plain(tq, tk, tv, window=window, block_kv=tile)
    assert (tfa.flash_attention.launches, tfa.flash_attention.pipe_launches) == before
    assert torch.equal(got, plain)
    assert float(np.abs(got.numpy() - want).max()) < 1e-5
    bf = tfa.flash_attention(*(x.to(BF16) for x in (tq, tk, tv)), window=window,
                             block_kv=tile)
    assert bf.dtype == BF16
    assert float(np.abs(bf.float().numpy() - want).max()) < 0.05


def test_build_compiles_flash_attention_in_parts(tmp_path, monkeypatch):
    """``_build.build_all`` compiles ``flash_attention.cu`` as ``PARTS``
    objects (``-DSMMB_PART=i -c``, no ``-shared``), all started before any
    is waited on, then links them into the one library; other sources in
    one call. A stand-in ``nvcc`` records its arguments."""
    from smmb_tpu_torch.kernels import _build

    log = tmp_path / "calls.txt"
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\n"
                    f'echo "$@" >> {log}\n'
                    'while [ "$#" -gt 0 ]; do if [ "$1" = "-o" ]; then : > "$2"; fi; shift; done\n')
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    logs = _build.build_all(("flash_attention.cu", "flash_decode.cu"))
    assert set(logs) == {"flash_attention.cu", "flash_decode.cu"}
    calls = log.read_text().splitlines()
    parts = [c for c in calls if "-DSMMB_PART=" in c]
    assert sorted(c.split("-DSMMB_PART=")[1].split()[0] for c in parts) == \
        [str(i) for i in range(_build.PARTS["flash_attention.cu"])]
    assert all(" -c " in c and "-shared" not in c for c in parts)
    link = [c for c in calls if ".part" in c and "-DSMMB_PART=" not in c]
    assert len(link) == 1 and link[0].count(".o") == _build.PARTS["flash_attention.cu"]
    assert "-shared" in link[0]
    assert [c for c in calls if "flash_decode.cu" in c and "-shared" in c]
    assert _build.library_path("flash_attention.cu").exists()
    assert not list((tmp_path / "build").glob("*.o"))  # the objects are removed
