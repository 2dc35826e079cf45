"""Packed ternary SpMM with fused bias + PReLU: the hand-written CUDA kernel
and its plain PyTorch version.

Replaces the Pallas TPU kernel ``smmb_tpu/kernels/packed_spmm.py::packed_spmm``
(``pallas_call`` at :388, body ``_kernel`` at :50). The kernel is
``csrc/packed_spmm.cu``, built with ``nvcc`` for ``sm_90a`` at first use
(``_build.py``) and called through ctypes. Two designs, one per kind of
arithmetic, neither with split-K or atomics:

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

In every mode ``block_m``/``block_n`` may name another tile of the mode
(``bench/autotune.py`` times them). Each output element sums in one register
in the same K order for every tile, so row r of an M-row call equals the
M=1 call bitwise, and every tile gives the same output.

Bound on this card: at the M=256, K=N=4096, ~10% nnz headline the bytes
(X, packed W, bias and Y moved once) bound every mode; f32 X times the
ternary W is counted at ``bench/roofline.py``'s ``"f32_ternary"`` rate (three
exact bf16 passes, as B2 runs them), which this f32 mode does not take: the
passes would change its sums. On the CUDA cores its own ceiling is the f32
rate. Its times are in PERF.md (measured by chip_smoke.py).

Dispatch: a CUDA tensor launches the kernel or raises; a CPU tensor runs
``packed_spmm_plain``. There is no fallback from one to the other.
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

_X_MODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_OUT_DTYPES = (torch.float32, torch.bfloat16)
DECODES = ("shift", "fold")

K_CHUNK = 32  # packed rows a K chunk of the tensor-core modes (csrc TC_PK)
F32_K_CHUNK = 8  # packed rows a K chunk of the f32 mode (csrc PK)
# the tensor-core modes' (BM, BN) tiles (csrc dispatch_tile instantiates each)
MMA_TILES = ((16, 64), (16, 128), (64, 64), (64, 128))
# the f32 mode's (BM, BN) tiles (csrc dispatch_float), largest micro-tile first
F32_TILES = ((64, 128), (64, 64), (16, 128), (16, 64))
NUM_SMS = 132  # an H100 SXM's SMs: the grid should fill about one wave


def tile_for(m: int, n: int, compute_dtype=torch.bfloat16) -> tuple[int, int, int]:
    """(BM, BN, K chunk in packed rows) of the kernel for an (m, n) output.

    The tensor-core modes take BM = 16 up to M = 32 (M ≤ 16 is one m16
    fragment; at M = 32 two 16-row blocks of 8 warps were faster on an H100
    than one 32-row block, so there is no 32-row tile) and BM = 64 above,
    and BN = 128 when that grid has at least 3/4 of a wave of blocks, else
    64. The f32 mode takes the first of ``F32_TILES`` (the largest
    micro-tile first; BM = 64 only above M = 32, where it leaves fewer than
    half its rows idle) whose grid has at least 3/4 of a wave, else 16×64,
    the most blocks. The K chunk (``K_CHUNK``, f32 ``F32_K_CHUNK``) does not
    depend on the tile: the K walk, and so every row's result, does not
    depend on M.
    """
    if compute_dtype == torch.float32:
        for bm, bn in F32_TILES:
            if (bm == 16 or m > 32) and -(-m // bm) * -(-n // bn) >= NUM_SMS * 3 // 4:
                break
        return bm, bn, F32_K_CHUNK
    bm = 16 if m <= 32 else 64
    rows = -(-m // bm)
    bn = 128 if rows * -(-n // 128) >= NUM_SMS * 3 // 4 else 64
    return bm, bn, K_CHUNK


def check_tile(block_m, block_n, compute_dtype) -> tuple[int, int] | None:
    """(block_m, block_n) checked against the kernel's tiles, or None when
    both are None (``tile_for`` picks; a None beside a given size stands for
    ``tile_for``'s size on that side). Every mode has BM in {16, 64} and BN
    in {64, 128} (``MMA_TILES``, f32 ``F32_TILES``). Any other size raises
    ``ValueError`` naming the mode's tiles: never a quiet fall back to
    another tile."""
    if block_m is None and block_n is None:
        return None
    tiles = F32_TILES if compute_dtype == torch.float32 else MMA_TILES
    bms = sorted({t[0] for t in tiles})
    bns = sorted({t[1] for t in tiles})
    if (block_m is not None and block_m not in bms) or (
            block_n is not None and block_n not in bns):
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
        pick it (a None beside a given size takes ``tile_for``'s size for
        that side). Every mode has BM in {16, 64} and BN in {64, 128}; any
        other size raises ``ValueError``. Every tile of a mode walks K in
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
    bm, bn, _ = tile_for(m, w.cols, compute_dtype)
    if tile is not None:
        bm, bn = tile[0] or bm, tile[1] or bn
    aligned = pieces_aligned(k, w.cols, xq.data_ptr(), w.data.data_ptr(), compute_dtype)
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
    return out


packed_spmm.launches = 0
