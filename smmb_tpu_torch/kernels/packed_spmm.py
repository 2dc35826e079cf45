"""Packed ternary SpMM with fused bias + PReLU: the hand-written CUDA kernel
and its plain PyTorch version.

Replaces the Pallas TPU kernel ``smmb_tpu/kernels/packed_spmm.py::packed_spmm``
(``pallas_call`` at :388, body ``_kernel`` at :50). The kernel is
``csrc/packed_spmm.cu``, built with ``nvcc`` for ``sm_90a`` at first use
(``_build.py``) and called through ctypes. Three designs, by kind of
arithmetic and size of M, none with split-K or atomics:

- f32 mode (the parity mode, never TF32): CUDA cores, one f32 FMA chain an
  output in one K order (``packed_spmm_f32_chain`` states it in plain
  adds: chunks of ``F32_K_CHUNK`` packed rows), K through a ``cp.async``
  ring of four chunks a stage, W decoded once a stage into shared memory
  (exact bf16 pairs) for all of a block's rows; where rows copy in 16-byte
  pieces, four copy warps stage and decode the next stage while the four
  FMA warps compute. The tile is one of ``F32_TILES`` (BM 16 or 64 by BN 64
  or 128; an 8×8 register micro-tile at 64×128, the lanes on columns at BM
  16), picked by ``tile_for`` to fill about a wave.
- bf16 and W2A8 modes: tensor cores through the warp MMA (``mma.sync``
  m16n8k16 bf16 → f32, m16n8k32 s8 → s32). W crosses shared memory as raw
  packed bytes and is decoded in registers into the B fragments; X is
  staged by 16-byte ``cp.async`` as four plane runs a row and loaded by
  ``ldmatrix``; a ring of K chunks of ``K_CHUNK`` packed rows. The tile is
  ``tile_for(m, n)``: BM 16 or 64 by M, BN 64/128 so that the grid fills
  about one wave of the card's 132 SMs.
- bf16 at large M (``WIDE_TILE``, 128×256, where its grid has at least
  ``WIDE_MIN_BLOCKS`` blocks and the rows copy in 16-byte pieces): the
  warpgroup MMA (``wgmma``, whose k16 step rounds as ``mma.sync``'s:
  ``scripts/torch_b1_wgmma_probe.py``) on ``Yᵀ = Wᵀ·Xᵀ``, decoded W the
  register operand, X and W's raw bytes
  brought by TMA through a ring that one producer lane keeps full for two
  consumer warpgroups; the same K walk, so the same bits.
  ``packed_spmm.launches_wide`` counts its calls.

In every mode ``block_m``/``block_n`` may name another tile of the mode
(``bench/autotune.py`` times them). Each output element sums in one register
in the same K order for every tile, so row r of an M-row call equals the
M=1 call bitwise, and every tile gives the same output.

Bound on this card: at the M=256, K=N=4096, ~10% nnz headline the bytes
(X, packed W, bias and Y moved once) bound every mode; at the LM prefill's
M = 4096–16384 the operations bound bf16; f32 X times the
ternary W is counted at ``bench/roofline.py``'s ``"f32_ternary"`` rate (three
exact bf16 passes, as B2 runs them), which this f32 mode does not take: the
passes would change its sums. On the CUDA cores its own ceiling is the f32
rate. Its times are in PERF.md (measured by chip_smoke.py).

Dispatch: a CUDA tensor launches the kernel or raises; a CPU tensor runs
``packed_spmm_plain``. There is no fallback from one to the other.

B1g (``grouped_spmm``, device kernel ``expert_spmm_grouped``) runs a
mixture's experts in one launch: X's rows lie in expert order, expert e's
rows ``offsets[e] .. offsets[e+1]`` against its plane of the stacked
(E, K/4, N) words, its bias row and a shared PReLU. Each block finds its
expert and row tile from ``offsets`` on the card (the grid has
⌈R/BM⌉ + E row tiles, the ones past the end exit), so the host never
reads the routing. The body is the bf16 ``mma.sync`` tile's K walk, so
every row equals B1's on the same row bit for bit.
``packed_spmm.launches_grouped`` counts its calls.
"""

from __future__ import annotations

import torch

from smmb_tpu_torch.formats.packed import (
    GROUP_ROWS,
    SUB,
    TernaryPacked,
    decode_words,
    unpack_ternary,
)
from smmb_tpu_torch.kernels import _build
from smmb_tpu_torch.ops.dense import prelu
from smmb_tpu_torch.ops.spmm import packed_spmm_ref
from smmb_tpu_torch.utils.spans import KERNEL_B1, KERNEL_B1G, span

_X_MODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_OUT_DTYPES = (torch.float32, torch.bfloat16)
DECODES = ("shift", "fold")

K_CHUNK = 32  # packed rows a K chunk of the tensor-core modes (csrc TC_PK)
F32_K_CHUNK = 8  # packed rows a K chunk of the f32 mode (csrc PK)
# the tensor-core modes' (BM, BN) tiles (csrc dispatch_tile instantiates each)
MMA_TILES = ((16, 64), (16, 128), (64, 64), (64, 128))
# bf16's large-M tile: the warpgroup-MMA body fed by TMA (csrc
# packed_spmm_mma_wg); X and W rows must copy in 16-byte pieces
WIDE_TILE = (128, 256)
# the f32 mode's (BM, BN) tiles (csrc dispatch_float), largest micro-tile first
F32_TILES = ((64, 128), (64, 64), (16, 128), (16, 64))
NUM_SMS = 132  # an H100 SXM's SMs: the grid should fill about one wave
# the fewest blocks of the wide tile that beat the small tiles on an H100:
# it lost at 32 blocks and fewer at 3 of 5 shapes, won at every one from 40
WIDE_MIN_BLOCKS = 40


def tiles_of(compute_dtype) -> tuple:
    """The (BM, BN) tiles the kernel has in ``compute_dtype``'s mode."""
    if compute_dtype == torch.float32:
        return F32_TILES
    return MMA_TILES + (WIDE_TILE,) if compute_dtype == torch.bfloat16 else MMA_TILES


def tile_for(m: int, n: int, compute_dtype=torch.bfloat16,
             aligned: bool = True) -> tuple[int, int, int]:
    """(BM, BN, K chunk in packed rows) of the kernel for an (m, n) output.

    bf16 takes ``WIDE_TILE`` (128×256, the warpgroup-MMA body) when M is at
    least its 128 rows, its grid has at least ``WIDE_MIN_BLOCKS`` = 40
    blocks and the rows copy in 16-byte pieces (``aligned``: TMA's rule,
    ``pieces_aligned``). The threshold is the card's: on an H100 at K =
    2560, a wide block is a lone SM's ~37 µs, so below about a third of a
    wave the small tiles' many blocks finish first (0.73–0.91× at 3–32
    blocks, the MLP's 256×4096 among them), and from 40 blocks the wide
    body won, 1.4× at 40–64 and 2.1–2.7× from 80 (PERF.md §6).
    Otherwise the tensor-core modes take BM = 16 up to M = 32 (M ≤ 16 is
    one m16 fragment; at M = 32 two 16-row blocks of 8 warps were faster on
    an H100 than one 32-row block, so there is no 32-row tile) and BM = 64
    above, and BN = 128 when that grid has at least 3/4 of a wave of
    blocks, else 64. The f32 mode takes the first of
    ``F32_TILES`` (the largest micro-tile first; BM = 64 only above M = 32,
    where it leaves fewer than half its rows idle) whose grid has at least
    3/4 of a wave, else 16×64, the most blocks. The K chunk (``K_CHUNK``,
    f32 ``F32_K_CHUNK``) does not depend on the tile: the K walk, and so
    every row's result, does not depend on M.
    """
    if compute_dtype == torch.float32:
        for bm, bn in F32_TILES:
            if (bm == 16 or m > 32) and -(-m // bm) * -(-n // bn) >= NUM_SMS * 3 // 4:
                break
        return bm, bn, F32_K_CHUNK
    wm, wn = WIDE_TILE
    if (compute_dtype == torch.bfloat16 and aligned and m >= wm
            and -(-m // wm) * -(-n // wn) >= WIDE_MIN_BLOCKS):
        return wm, wn, K_CHUNK
    bm = 16 if m <= 32 else 64
    rows = -(-m // bm)
    bn = 128 if rows * -(-n // 128) >= NUM_SMS * 3 // 4 else 64
    return bm, bn, K_CHUNK


def check_tile(block_m, block_n, compute_dtype) -> tuple[int, int] | None:
    """(block_m, block_n) checked against the kernel's tiles, or None when
    both are None (``tile_for`` picks). Every mode has BM in {16, 64} and BN
    in {64, 128} (``MMA_TILES``, f32 ``F32_TILES``); a None beside one of
    those sizes stands for the small tiles' size on that side. bf16 has
    ``WIDE_TILE`` too, whose one side names it whole. Any other size or
    pair raises ``ValueError`` naming the mode's tiles: never a quiet fall
    back to another tile."""
    if block_m is None and block_n is None:
        return None
    tiles = tiles_of(compute_dtype)
    wm, wn = WIDE_TILE
    if WIDE_TILE in tiles and (block_m, block_n) in ((wm, wn), (wm, None), (None, wn)):
        return WIDE_TILE
    small = [t for t in tiles if t != WIDE_TILE]
    if (block_m is not None and block_m not in {t[0] for t in small}) or (
            block_n is not None and block_n not in {t[1] for t in small}):
        mode = str(compute_dtype).split(".")[-1]
        raise ValueError(f"packed_spmm has no {block_m}x{block_n} tile in {mode}: its tiles "
                         f"(block_m x block_n) are {', '.join(f'{a}x{b}' for a, b in tiles)}")
    return block_m, block_n


def pieces_aligned(k: int, n: int, x_ptr: int, w_ptr: int, compute_dtype) -> bool:
    """Whether the kernel may copy X and W rows in 16-byte pieces: K a
    multiple of the piece's elements (4 f32, 8 bf16, 16 int8 codes), N of 16
    bytes, and both pointers 16-byte aligned. Else it loads elements."""
    per_piece = 16 // compute_dtype.itemsize
    return k % per_piece == 0 and n % 16 == 0 and x_ptr % 16 == 0 and w_ptr % 16 == 0


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """W2A8 activation quantization (smmb_tpu/kernels/packed_spmm.py:350-357).

    Per-row absmax: ``scale = max(max|x| / 127, 1e-12)`` in ``x``'s dtype,
    codes ``clip(round(x / scale), -127, 127)`` as int8 (``torch.round``
    rounds half to even, like ``jnp.round``). Returns (codes, f32 scale of
    shape (M, 1)).
    """
    scale = x.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    codes = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return codes, scale.to(torch.float32)


def packed_spmm_plain(
    x: torch.Tensor,
    w: TernaryPacked,
    b: torch.Tensor | None = None,
    alpha: float | None = None,
    *,
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, for 2-D ``x``, all three modes.

    f32 / bf16: ``packed_spmm_ref`` (decode, cast X, one f32 product). int8:
    the same quantization as the kernel, then exact integer sums (an f64
    product of integers below 2**53 is exact), per-row dequant, bias, PReLU.
    """
    if compute_dtype != torch.int8:
        return packed_spmm_ref(x, w, b, alpha, dtype=compute_dtype)
    codes, scale = quantize_rows(x)
    wd = decode_words(w.data, torch.float64)[: x.shape[1]]
    acc = torch.matmul(codes.to(torch.float64), wd)
    r = acc.to(torch.float32) * scale
    if b is not None:
        r = r + b.to(torch.float32)
    if alpha is not None:
        r = prelu(r, alpha)
    return r.to(x.dtype)


def packed_spmm_f32_chain(
    x: torch.Tensor,
    w: TernaryPacked,
    b: torch.Tensor | None = None,
    alpha: float | None = None,
) -> torch.Tensor:
    """The f32 kernel's sums stated in plain f32 adds, for 2-D f32 ``x``.

    The kernel takes ``fmaf(x, w, acc)`` into one register an output in one
    K order: chunks of ``F32_K_CHUNK`` packed rows, in a chunk plane 0's
    rows, then plane 1's, 2's and 3's. With a ternary W each product is
    exact, so ``acc + x[:, c] * w[c]`` over that order (columns past K add
    nothing) is the kernel's result bit for bit under every tile; then the
    bias and PReLU in f32, as its epilogue. One add a column: for tests and
    checks, never a main path.
    """
    wd, k = unpack_ternary(w).to(x.device), x.shape[1]
    acc = torch.zeros(x.shape[0], w.cols, dtype=torch.float32, device=x.device)
    for pr0 in range(0, w.data.shape[0], F32_K_CHUNK):
        for i in range(4):
            col0 = (pr0 // SUB) * GROUP_ROWS + i * SUB + pr0 % SUB
            for col in range(col0, min(col0 + F32_K_CHUNK, k)):
                acc = acc + x[:, col:col + 1] * wd[col]
    if b is not None:
        acc = acc + b
    return acc if alpha is None else torch.where(acc > 0, acc, alpha * acc)


def _check_cuda_args(x, w, b, compute_dtype):
    dev = x.device
    if x.dtype not in _OUT_DTYPES:
        raise TypeError(f"packed_spmm kernel takes f32 or bf16 x, got {x.dtype}")
    if compute_dtype not in _X_MODE:
        raise TypeError(f"unsupported compute_dtype {compute_dtype}")
    if w.data.device != dev or w.data.dtype != torch.int8:
        raise ValueError("w.data must be an int8 tensor on x's device")
    if not w.data.is_contiguous():
        raise ValueError("w.data must be contiguous")
    kp, n = w.data.shape
    if n != w.cols or kp * 4 < w.rows or (kp * 4) % GROUP_ROWS:
        raise ValueError(f"packed data shape {tuple(w.data.shape)} does not "
                         f"match a ({w.rows}, {w.cols}) matrix")
    if b is not None and (b.device != dev or b.shape != (n,)):
        raise ValueError(f"bias must be ({n},) on x's device")


def packed_spmm(
    x: torch.Tensor,
    w: TernaryPacked,
    b: torch.Tensor | None = None,
    alpha: float | None = None,
    *,
    compute_dtype=torch.float32,
    block_m: int | None = None,
    block_n: int | None = None,
    block_k: int | None = None,
    decode: str = "shift",
) -> torch.Tensor:
    """``Y = prelu(X @ W + B, alpha)`` with 2-bit packed ternary W.

    Args:
      x: (..., K) activations, float32 or bfloat16.
      w: TernaryPacked weights with logical shape (K, N).
      b: optional (N,) bias, added in f32.
      alpha: optional PReLU slope; None = no activation.
      compute_dtype: float32 (parity mode, no TF32), bfloat16 (X cast once;
        W decodes exactly, so the error comes only from the cast) or int8
        (W2A8: per-row absmax int8 X, int32 sums, per-row dequant).
      block_m, block_n: the kernel's output tile, None to let ``tile_for``
        pick it (a None beside a given size takes the small tiles' size for
        that side). Every mode has BM in {16, 64} and BN in {64, 128}; bf16
        has 128×256 too (either side names it; it raises ``ValueError`` on
        a call whose rows do not copy in 16-byte pieces); any other size
        raises ``ValueError``. Every tile of a mode walks K in
        the same chunks, so the output is bitwise the same under every tile
        (``bench/autotune.py`` picks the fastest). On the CPU the tile is
        checked, then the plain version runs.
      block_k, decode: kept for compatibility with the JAX signature, where
        they choose among TPU K tilings and decode strategies with identical
        results; the Hopper kernel has one K walk and one decode. ``decode``
        must be "shift" or "fold" and ``block_k`` a multiple of 512.
    Returns:
      (..., N) in x.dtype.
    """
    if decode not in DECODES:
        raise ValueError(f"decode={decode!r} is not one of {DECODES}")
    if block_k is not None and block_k % GROUP_ROWS:
        raise ValueError(f"block_k={block_k} must be a multiple of {GROUP_ROWS}")
    tile = check_tile(block_m, block_n, compute_dtype)
    if x.dim() > 2:
        lead = x.shape[:-1]
        y = packed_spmm(
            x.reshape(-1, x.shape[-1]), w, b, alpha,
            compute_dtype=compute_dtype, block_m=block_m, block_n=block_n,
            block_k=block_k, decode=decode,
        )
        return y.reshape(*lead, y.shape[-1])
    with span(KERNEL_B1):
        m, k = x.shape
        if k != w.rows:
            raise ValueError(f"x K dim {k} != weight rows {w.rows}")
        if x.device.type == "cpu":
            return packed_spmm_plain(x, w, b, alpha, compute_dtype=compute_dtype)
        if x.device.type != "cuda":
            raise ValueError(f"packed_spmm runs on cuda or cpu, not {x.device}")
        _check_cuda_args(x, w, b, compute_dtype)
        if compute_dtype == torch.int8:
            xq, scale = quantize_rows(x)
        else:
            xq, scale = x.to(compute_dtype).contiguous(), None
        bias = None if b is None else b.to(torch.float32).contiguous()
        out = torch.empty((m, w.cols), dtype=x.dtype, device=x.device)
        if m == 0:
            return out
        aligned = pieces_aligned(k, w.cols, xq.data_ptr(), w.data.data_ptr(), compute_dtype)
        if tile is None:
            bm, bn, _ = tile_for(m, w.cols, compute_dtype, aligned)
        elif tile == WIDE_TILE:
            if not aligned:
                raise ValueError("the 128x256 tile copies X and W by TMA: K must be a multiple "
                                 "of 8, N of 16, and both 16-byte aligned")
            bm, bn = tile
        else:
            bm, bn, _ = tile_for(m, w.cols, compute_dtype, aligned=False)
            bm, bn = tile[0] or bm, tile[1] or bn
        fn = _build.packed_spmm_lib().smmb_packed_spmm
        with torch.cuda.device(x.device):
            rc = fn(
                xq.data_ptr(), w.data.data_ptr(),
                None if bias is None else bias.data_ptr(),
                None if scale is None else scale.data_ptr(),
                out.data_ptr(),
                m, k, w.cols, w.data.shape[0],
                _X_MODE[compute_dtype], int(x.dtype == torch.bfloat16),
                bm, bn, int(aligned),
                int(alpha is not None), 0.0 if alpha is None else float(alpha),
                torch.cuda.current_stream(x.device).cuda_stream,
            )
        if rc != 0:
            raise RuntimeError(f"packed_spmm kernel launch failed: CUDA error {rc}")
        packed_spmm.launches += 1
        if (bm, bn) == WIDE_TILE:
            packed_spmm.launches_wide += 1
        return out


packed_spmm.launches = 0
packed_spmm.launches_wide = 0  # the calls the wide bf16 body took


def grouped_spmm_plain(
    x: torch.Tensor,
    w: TernaryPacked,
    b: torch.Tensor | None,
    offsets: torch.Tensor,
    alpha: float | None = None,
    *,
    compute_dtype=torch.bfloat16,
    out_dtype=None,
) -> torch.Tensor:
    """B1g's function in plain PyTorch, in its one mode, bf16:
    ``packed_spmm_plain`` of X (every row, at least 8, as f32 so that
    nothing is rounded before ``out_dtype``) against all experts' planes
    side by side, each row's own expert's columns kept, then its bias and
    the PReLU, as B1's plain epilogue adds them. Every row meets every
    expert: for tests and the CPU, never a main path. Where the library's
    f32 product gives an output the same bits whatever the rows and columns
    beside it (the CPU's at K ≤ 512 and M ≥ 2), each row is B1's plain row,
    bit for bit."""
    if compute_dtype != torch.bfloat16:
        raise TypeError(f"the grouped kernel computes in bfloat16, not {compute_dtype}")
    r = x.shape[0]
    e, kp, n = w.data.shape
    out_dtype = out_dtype or x.dtype
    xf = x.to(torch.float32)
    if r < 8:
        xf = torch.cat([xf, xf.new_zeros(8 - r, xf.shape[1])])
    planes = TernaryPacked(data=w.data.permute(1, 0, 2).reshape(kp, e * n), rows=w.rows,
                           cols=e * n, nnz=w.nnz)
    y = packed_spmm_plain(xf, planes, compute_dtype=compute_dtype)[:r].view(r, e, n)
    ends = offsets.to(x.device)[1:].contiguous()
    expert = torch.searchsorted(ends, torch.arange(r, device=x.device, dtype=ends.dtype),
                                right=True)
    y = y.gather(1, expert[:, None, None].expand(r, 1, n))[:, 0]
    if b is not None:
        y = y + b.to(torch.float32)[expert]
    if alpha is not None:
        y = prelu(y, alpha)
    return y.to(out_dtype)


def grouped_spmm(
    x: torch.Tensor,
    w: TernaryPacked,
    b: torch.Tensor | None,
    offsets: torch.Tensor,
    alpha: float | None = None,
    *,
    compute_dtype=torch.bfloat16,
    out_dtype=None,
) -> torch.Tensor:
    """B1g: ``Y[r] = prelu(X[r] @ W[e] + b[e], alpha)`` for each row r of
    expert e's segment, one launch for all experts.

    Args:
      x: (R, K) rows in expert order, float32 or bfloat16.
      w: the stacked ``TernaryPacked`` of ``pack_moe``: data (E, K/4, N).
      b: (E, N) biases, added in f32, or None.
      offsets: (E + 1,) int, expert e's rows are ``offsets[e] ..
        offsets[e + 1]`` (offsets[E] = R); read on the card only.
      alpha: PReLU slope, None = no activation.
      compute_dtype: bfloat16, B1's tensor-core mode (X cast once), on the
        card and the CPU alike.
      out_dtype: the output's dtype, f32 or bf16 (default x's).
    Returns:
      (R, N) in ``out_dtype``; row r bitwise B1's on the same row and plane.
    """
    with span(KERNEL_B1G):
        r, k = x.shape
        e, kp, n = w.data.shape
        if k != w.rows or n != w.cols:
            raise ValueError(f"x {tuple(x.shape)} against stacked planes "
                             f"({e}, {w.rows}, {w.cols})")
        if offsets.shape != (e + 1,):
            raise ValueError(f"offsets must be ({e + 1},), got {tuple(offsets.shape)}")
        if compute_dtype != torch.bfloat16:
            raise TypeError(f"the grouped kernel computes in bfloat16, not {compute_dtype}")
        if x.device.type == "cpu":
            return grouped_spmm_plain(x, w, b, offsets, alpha, out_dtype=out_dtype)
        out_dtype = out_dtype or x.dtype
        if out_dtype not in _OUT_DTYPES:
            raise TypeError(f"grouped_spmm writes f32 or bf16, not {out_dtype}")
        if w.data.device != x.device or w.data.dtype != torch.int8 \
                or not w.data.is_contiguous():
            raise ValueError("w.data must be a contiguous int8 tensor on x's device")
        if kp * 4 < k or (kp * 4) % GROUP_ROWS:
            raise ValueError(f"packed data shape {tuple(w.data.shape)} does not match K={k}")
        if b is not None and (b.device != x.device or b.shape != (e, n)):
            raise ValueError(f"bias must be ({e}, {n}) on x's device")
        xq = x.to(torch.bfloat16).contiguous()
        bias = None if b is None else b.to(torch.float32).contiguous()
        off = offsets.to(device=x.device, dtype=torch.int32).contiguous()
        out = torch.empty((r, n), dtype=out_dtype, device=x.device)
        if r == 0:
            return out
        aligned = pieces_aligned(k, n, xq.data_ptr(), w.data.data_ptr(), torch.bfloat16)
        # the tile does not change the bits: 64 rows once an expert averages
        # more than 32 of them, else 16
        bm = 64 if r > 32 * e else 16
        fn = _build.packed_spmm_lib().smmb_expert_spmm_grouped
        with torch.cuda.device(x.device):
            rc = fn(
                xq.data_ptr(), w.data.data_ptr(), None if bias is None else bias.data_ptr(),
                off.data_ptr(), out.data_ptr(), r, k, n, kp, e,
                int(out_dtype == torch.bfloat16), bm, int(aligned),
                int(alpha is not None), 0.0 if alpha is None else float(alpha),
                torch.cuda.current_stream(x.device).cuda_stream,
            )
        if rc != 0:
            raise RuntimeError(f"grouped_spmm kernel launch failed: CUDA error {rc}")
        packed_spmm.launches_grouped += 1
        return out


packed_spmm.launches_grouped = 0  # B1g's calls (grouped_spmm)
