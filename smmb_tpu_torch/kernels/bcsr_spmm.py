"""BCSR block-sparse SpMM with fused bias + PReLU: the hand-written CUDA
kernel (B2) and its plain PyTorch version.

Replaces the Pallas TPU kernel
``smmb_tpu/kernels/bcsr_spmm.py::bcsr_spmm_pallas`` (``pallas_call`` at
:260, body ``_kernel`` at :112). The kernel is ``csrc/bcsr_spmm.cu``, built
with ``nvcc`` for ``sm_90a`` at first use (``_build.py``) and called
through ctypes.

The TPU kernel walks the stored blocks in one sequential grid and carries
each output tile's running sum in its output buffer between visits. Here
one thread block owns an output tile and walks its block column's run
``[col_start[j], col_start[j+1])`` itself, in the prepared (column-major)
order. It seeds nothing and revisits nothing: the bias is added once after
the last block, then PReLU, then one store in ``x``'s dtype. A block column
with no stored block writes the activated bias. No split of K and no
atomics, so a row's result depends neither on M nor on the tile.

Two bodies, chosen by the block shape before the launch (``bcsr_route``):

- ``"mma"`` (``r % 64 == 0``, the benchmark's 128×128 blocks): tensor cores
  through the warp MMA (``mma.sync`` m16n8k16 bf16 → f32). Per stored block,
  the X slice and the raw 2-bit code bytes are copied by 16-byte
  ``cp.async`` into a ring of chunks that runs on across blocks; the codes
  are decoded in registers into the MMA's B fragments. bf16 X is one pass.
  f32 X (never TF32) is split in the kernel into three bf16 pieces, ``x = hi
  + mid + lo`` exactly (``split_bf16x3`` is the same arithmetic), and three
  passes give the exact f32 products. The tensor core's f32 accumulation
  truncates, so each block sums its hi pass and its mid + lo passes in two
  zeroed fragments that are added into the running f32 sums with
  round-to-nearest, block by block. The tile is ``bcsr_tile(m, n, c)``.
- ``"cuda_core"`` (the tests' 4- and 8-row blocks): a 64×128 tile, per stored
  block the X slice and the decoded block staged in shared memory 32 block
  rows at a time, a 4×8 f32 register micro-tile a thread.

Semantics kept from the TPU kernel: partial sums are carried in f32 whatever
``x.dtype`` is, and the result is cast once at the end; every product is
exact (W is ±1/0, f32 X in three exact pieces, bf16 X as is), so only the
sums round. Block shape: ``r % 4 == 0`` (``bcsr_prepare``) and ``c % 128 ==
0``, JAX's interpret-mode rule (its ``r % 128`` is a Mosaic lane constraint
this card does not have).

Bound on this card: f32 X times a ternary W runs at the bf16 tensor-core
rate over three passes (``bench/roofline.py``'s ``"f32_ternary"``); the
showcase's 256×1024×4096 is bound by those operations, M = 1 by W's bytes.
The mma body executes the dense in-block count 2·M·k·r·c (three times in
f32); skipping the zeros inside a block is later work. On the card its k16
step is bound by the B decode (bf16; the warps split the columns first so
that a decoded register feeds up to four row fragments) or the A split
(f32; one row fragment a warp, its split feeding up to 8 column
fragments), and a chain of dependent reads (``col_start``, ``blk_row``, the
first chunk) costs a few µs a call. Times in PERF.md (chip_smoke.py's
phase 16, also under every tile).

Dispatch: a CUDA tensor launches the kernel or raises; a CPU tensor runs
``bcsr_spmm_kernel_plain``. There is no fallback from one to the other.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from smmb_tpu_torch.formats.bcsr import BCSR
from smmb_tpu_torch.formats.tcsc import _host
from smmb_tpu_torch.kernels import _build
from smmb_tpu_torch.ops.dense import full_f32_matmul, prelu
from smmb_tpu_torch.utils.device import resolve_device

LANE = 128  # block-column alignment: the CUDA-core body's tile width (csrc BN)
_X_DTYPES = (torch.float32, torch.bfloat16)
MMA_R = 64  # block rows the mma body needs a multiple of (csrc MMA_R)
CHUNK_ROWS = 32  # packed rows a chunk of the mma body (csrc MMA_PK)
RING = 3  # chunks in flight in the mma body's cp.async ring (csrc MMA_STAGES)
MMA_TILES = ((16, 32), (16, 64), (16, 128), (64, 32), (64, 64), (64, 128))
NUM_SMS = 132  # an H100 SXM's SMs: bcsr_tile's default, for checks off the card


@dataclasses.dataclass(frozen=True)
class BCSRPrepared:
    """Kernel-ready BCSR: blocks in column-major order + sentinel tail.

    ``blk_row``/``blk_col``, ``values`` and ``col_has_blocks`` are
    byte-identical to JAX's ``BCSRPrepared``: the block indices have length
    k+1 with a -1 sentinel, ``values[b, p, :]`` holds block rows ``p,
    r/4+p, 2r/4+p, 3r/4+p`` in its four 2-bit fields (``0b01`` = +1,
    ``0b11`` = -1), and ``col_has_blocks`` marks (as 1.0 per element) the
    output columns that receive a block. ``col_start[bc + 1]`` is the port's
    own: the start of each block column's run of blocks.
    """

    blk_row: torch.Tensor  # int32[k + 1]
    blk_col: torch.Tensor  # int32[k + 1]
    values: torch.Tensor  # int8[k, r // 4, c]
    col_has_blocks: torch.Tensor  # float32[cols]
    col_start: torch.Tensor  # int32[cols // c + 1]
    rows: int
    cols: int
    r: int
    c: int
    k: int

    def weight_bytes(self) -> int:
        """Device-memory bytes per full weight read: codes + steering indices."""
        return self.k * (self.r // 4) * self.c + 2 * 4 * (self.k + 1)


def col_starts(blk_col: np.ndarray, k: int, bc: int) -> np.ndarray:
    """int32[bc + 1] start of each block column's run in column-sorted
    ``blk_col`` (its sentinel, entry k, is ignored)."""
    counts = np.bincount(np.asarray(blk_col[:k], np.int64), minlength=bc)
    out = np.zeros(bc + 1, np.int32)
    np.cumsum(counts, out=out[1:])
    return out


def bcsr_prepare(w: BCSR, device=None) -> BCSRPrepared:
    """Host side: sort the blocks column-major (one run per block column),
    pack their values to 2-bit codes, and place the result on ``device``
    (None = the CUDA card)."""
    dev = resolve_device(device)
    if w.r % 4:
        raise ValueError(f"bcsr_prepare needs r % 4 == 0, got r={w.r}")
    e = np.arange(w.k)
    rows = (np.searchsorted(_host(w.b_row_start), e, side="right") - 1).astype(np.int32)
    cols = _host(w.b_col_idx)
    order = np.lexsort((rows, cols))  # by column, then by row
    blk_row = np.concatenate([rows[order], [-1]]).astype(np.int32)
    blk_col = np.concatenate([cols[order], [-1]]).astype(np.int32)
    values = _host(w.b_values)[order]  # (k, r, c) float ternary
    sub = w.r // 4
    t = np.zeros(values.shape, np.int8)
    t[values == 1.0] = 1
    t[values == -1.0] = -1
    codes = (t & 3).astype(np.uint8).reshape(len(values), 4, sub, w.c)
    packed = (codes[:, 0] | (codes[:, 1] << 2) | (codes[:, 2] << 4)
              | (codes[:, 3] << 6)).astype(np.int8)
    has = np.zeros(w.bc, np.float32)
    has[cols] = 1.0
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return BCSRPrepared(
        blk_row=put(blk_row), blk_col=put(blk_col), values=put(packed),
        col_has_blocks=put(np.repeat(has, w.c)),
        col_start=put(col_starts(blk_col, w.k, w.bc)),
        rows=w.rows, cols=w.cols, r=w.r, c=w.c, k=w.k,
    )


def decode_blocks(values: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """int8[k, r/4, c] codes → dense (k, r, c) blocks in ``dtype``: field p
    of byte ``[b, i, j]`` is block row ``p·r/4 + i``, decoded by the int32
    shift sign-extend ``(w << (30 - 2p)) >> 30``."""
    w32 = values.to(torch.int32)
    planes = [((w32 << (30 - 2 * p)) >> 30) for p in range(4)]
    return torch.cat(planes, dim=1).to(dtype)


def bcsr_route(r: int, c: int) -> str:
    """The body the kernel takes for r×c blocks (``c % 128 == 0``).

    ``"mma"`` where ``r % 64 == 0``: then ``r/4`` is a multiple of 16, so
    one k16 MMA step takes 16 packed rows of one plane, and the tensor cores
    run it (the showcase's, the sweep's and the block-sparse workload's
    128×128 blocks). ``"cuda_core"`` otherwise (the tests' 4- and 8-row
    blocks): f32 FMA. A route, not a fallback: the shape decides before the
    launch, and a launch that fails raises.
    """
    if c % LANE:
        raise ValueError(f"no kernel route for c={c}: c % {LANE} != 0")
    return "mma" if r % MMA_R == 0 else "cuda_core"


def bcsr_tile(m: int, n: int, c: int, sms: int = NUM_SMS) -> tuple[int, int]:
    """(BM, BN) of the mma body for an (m, n) output of c-wide blocks on a
    card of ``sms`` SMs (the wrapper passes the card's own count).

    BM = 16 up to M = 64, else 64: on the card a 16-row tile is the fastest
    at M = 64 and a 64-row one at M = 256 (chip_smoke.py's phase 16, by
    tile). BN is the widest of 128, 64 and 32 whose grid has at least 3/4 of
    a wave (99 blocks of an H100 SXM's 132 SMs), else 32, the most blocks
    (M = 1 at N = 4096 gets 128 blocks where a 128-column tile gives 32).
    Every BN divides c. The tile changes no sum: each output sums in the
    order of its block column's run and of the K walk inside a block, so
    rows are bitwise the M = 1 call's under every tile.
    """
    bm = 16 if m <= 64 else 64
    rows = -(-m // bm)
    for bn in (128, 64):
        if c % bn == 0 and rows * (n // bn) >= sms * 3 // 4:
            return bm, bn
    return bm, 32


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_bf16x3(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """f32 ``x`` as three bf16 pieces with ``hi + mid + lo == x`` exactly,
    the arithmetic of the mma body's f32 split (``csrc/bcsr_spmm.cu``):
    ``hi`` is x rounded to nearest even, ``mid`` the remainder ``x - hi`` so
    rounded, ``lo`` what is left. x has 24 significant bits, each piece
    takes 8, and a remainder after rounding to nearest has at most half the
    piece's ulp, so its sign costs no bit. Exact for x = 0 and |x| ≥ 2^-103,
    where every nonzero piece is a normal bf16 (each f32 subtraction is
    exact: the operands are within a factor of two)."""
    x = x.to(torch.float32)
    hi = x.to(torch.bfloat16)
    r1 = x - hi.to(torch.float32)
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.to(torch.float32)).to(torch.bfloat16)
    return hi, mid, lo


def _check(x: torch.Tensor, w: BCSRPrepared) -> None:
    if x.dim() != 2:
        raise ValueError(f"x must be (M, K), got shape {tuple(x.shape)}")
    if x.shape[1] != w.rows:
        raise ValueError(f"x K dim {x.shape[1]} != weight rows {w.rows}")
    if w.c % LANE:
        raise ValueError(
            f"kernel needs c % {LANE} == 0 blocks, got ({w.r}, {w.c}); "
            "use smmb_tpu_torch.ops.bcsr_spmm for small blocks")


def _seed(x: torch.Tensor, w: BCSRPrepared, b, alpha) -> torch.Tensor:
    """(N,) f32 bias seeding each output column: the activated bias where a
    column receives no block (it never reaches the epilogue)."""
    bias = (torch.zeros(w.cols, dtype=torch.float32, device=x.device)
            if b is None else b.to(device=x.device, dtype=torch.float32))
    if alpha is None:
        return bias
    return torch.where(w.col_has_blocks.to(x.device) > 0, bias, prelu(bias, alpha))


def bcsr_spmm_kernel_plain(
    x: torch.Tensor,
    w: BCSRPrepared,
    b: torch.Tensor | None = None,
    alpha: float | None = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: decode the codes, one f32
    product per stored block (TF32 off; bf16 X widened exactly), the blocks
    of each column summed in the prepared order, then the seed bias, PReLU
    on touched columns and one cast to ``x.dtype``."""
    _check(x, w)
    m = x.shape[0]
    seed = _seed(x, w, b, alpha)
    if w.k == 0:
        return seed.expand(m, w.cols).to(x.dtype)
    k = w.k
    xp = x.t().reshape(w.rows // w.r, w.r, m)  # panels by block row
    xg = xp.index_select(0, w.blk_row[:k].long())  # (k, r, M)
    part = full_f32_matmul(xg.transpose(1, 2), decode_blocks(w.values))  # (k, M, c)
    acc = torch.zeros((w.cols // w.c, m, w.c), dtype=torch.float32, device=x.device)
    acc.index_add_(0, w.blk_col[:k].long(), part)
    y = acc.permute(1, 0, 2).reshape(m, w.cols) + seed
    if alpha is not None:
        touched = w.col_has_blocks.to(x.device) > 0
        y = torch.where(touched, prelu(y, alpha), y)
    return y.to(x.dtype)


def bcsr_spmm_kernel(
    x: torch.Tensor,
    w: BCSRPrepared,
    b: torch.Tensor | None = None,
    alpha: float | None = None,
    *,
    block_m: int = 256,
    x_resident: bool | None = None,
) -> torch.Tensor:
    """``Y = prelu(X @ W + B, alpha)`` over prepared BCSR weights (kernel B2).

    Args:
      x: (M, K) activations, float32 or bfloat16.
      w: ``bcsr_prepare`` output with rows=K, cols=N, r % 4 == 0 and
        c % 128 == 0 (else ``ValueError``).
      b: optional (N,) bias, added in f32.
      alpha: optional PReLU slope; None = no activation. Columns holding no
        block come back as the (activated) bias.
      block_m, x_resident: kept for the JAX signature. They choose the TPU's
        M tile and whether its (block_m, K) X panel stays in VMEM; the
        Hopper kernel picks its tile by ``bcsr_tile``, reads each block's X
        slice through the cache, and its result depends on neither.
    Returns:
      (M, N) in x.dtype.
    """
    _check(x, w)
    if block_m <= 0:
        raise ValueError(f"block_m={block_m} must be positive")
    if x.device.type == "cpu":
        return bcsr_spmm_kernel_plain(x, w, b, alpha)
    if x.device.type != "cuda":
        raise ValueError(f"bcsr_spmm_kernel runs on cuda or cpu, not {x.device}")
    if x.dtype not in _X_DTYPES:
        raise TypeError(f"bcsr_spmm kernel takes f32 or bf16 x, got {x.dtype}")
    m = x.shape[0]
    if w.k == 0:  # no block: the seeded bias, no launch
        return _seed(x, w, b, alpha).expand(m, w.cols).to(x.dtype)
    if m == 0:  # no row: no launch
        return torch.empty((0, w.cols), dtype=x.dtype, device=x.device)
    dev = x.device
    for name in ("values", "blk_row", "col_start"):
        t = getattr(w, name)
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"w.{name} must be contiguous on x's device")
    if w.values.data_ptr() % 16:
        raise ValueError("w.values must be 16-byte aligned")
    if b is not None and (b.device != dev or b.shape != (w.cols,)):
        raise ValueError(f"bias must be ({w.cols},) on x's device")
    mma = bcsr_route(w.r, w.c) == "mma"
    tile = bcsr_tile(m, w.cols, w.c, _sm_count(dev.index)) if mma else (0, 0)
    bias = None if b is None else b.to(torch.float32).contiguous()
    out = _launch(x, w, bias, alpha, tile)
    bcsr_spmm_kernel.launches += 1
    return out


def _launch(x, w: BCSRPrepared, bias, alpha, tile: tuple[int, int]) -> torch.Tensor:
    """One launch of the CUDA kernel on inputs ``bcsr_spmm_kernel`` checked
    (``bias`` f32 and contiguous, or None), under ``tile``: the wrapper's
    ``bcsr_tile`` for the mma route, (0, 0) for the CUDA-core one; the tile
    sweeps of chip_smoke.py and of the card tests pass the other tiles of
    ``MMA_TILES``. Allocates the output; counts nothing."""
    bm, bn = tile
    if bcsr_route(w.r, w.c) == "mma":
        if (bm, bn) not in MMA_TILES or w.c % bn:
            raise ValueError(f"no mma tile {bm}x{bn} for {w.r}x{w.c} blocks")
    elif tile != (0, 0):
        raise ValueError(f"the CUDA-core body takes no tile, got {bm}x{bn}")
    xc = x.contiguous()
    if bm and xc.data_ptr() % 16:  # the mma body copies X in 16-byte pieces
        xc = xc.clone()
    m = x.shape[0]
    out = torch.empty((m, w.cols), dtype=x.dtype, device=x.device)
    fn = _build.bcsr_spmm_lib().smmb_bcsr_spmm
    with torch.cuda.device(x.device):
        rc = fn(
            xc.data_ptr(), int(x.dtype == torch.bfloat16), w.values.data_ptr(),
            w.blk_row.data_ptr(), w.col_start.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            m, w.rows, w.cols, w.r, w.c, bm, bn,
            int(alpha is not None), 0.0 if alpha is None else float(alpha),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"bcsr_spmm kernel launch failed: CUDA error {rc}")
    return out


bcsr_spmm_kernel.launches = 0
