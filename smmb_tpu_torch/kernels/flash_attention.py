"""Flash (online-softmax) prefill attention: the hand-written CUDA kernel B9
and its plain PyTorch version.

Replaces the Pallas TPU kernel of ``smmb_tpu/kernels/flash_attention.py``
(``flash_attention``, ``pallas_call`` at :662 causal and :688 non-causal).
The kernel is ``csrc/flash_attention.cu``, built with ``nvcc`` for
``sm_90a`` at first use (``_build.py``) and called through ctypes: a block
owns a tile of query rows of one KV head's query heads and walks the live
kv tiles in ascending order, so the (T, S) score tensor never reaches device
memory. It has two device bodies, and ``kernel_route`` names the one a call
takes, with its tile (the one place that decides):

* **mma** (bf16 at hd 64 and 128): tensor cores, ``mma.sync`` m16n8k16 with
  bf16 inputs and f32 sums, FlashAttention-2's shape. A block of 4 warps
  owns 64 query rows (16 a warp) and walks kv tiles of 64 columns through
  a two-slot ``cp.async`` ring; scores, softmax, P and the output
  accumulator stay in registers. Rounding points: q·qscale to bf16, the
  scores and P·V as the MMA's f32 sums, p to bf16 from the f32 exp2, the
  output acc / l to bf16.
* **cuda_core** (f32 at any hd, bf16 at other widths): f32 FMAs on CUDA
  cores (no TF32), 256 threads. Its outputs are bitwise the first port's
  CUDA-core body's: each score and each P·V an fmaf chain in the first
  port's order, the row sums in its lane order, and its kv tile of 64
  columns, or 32 / 16 where a wide head did not fit that body's shared
  memory (``kernel_tile``, frozen: the tile sets where the online softmax
  rescales). A block owns ``row_tile`` query rows (16 to 128, the wrapper's
  pick: fewer where a call has few rows, so more blocks fill the card); Q,
  scores, softmax state, P·V and the accumulator in registers but for Q
  and P's round trip through shared memory, K through a two-slot
  ``cp.async`` ring, V one slot. Rounding points: q·qscale to q's dtype,
  the scores and P·V as fmaf chains in f32, p to v's dtype, acc / l to q's
  dtype.

Both bodies share the plain version ``flash_attention_plain`` as their
reference (the same rounding points, with the products exact in f64 and
rounded once to f32). Any hd is taken as it is (JAX pads to 128).

Dispatch: a CUDA tensor launches the body ``kernel_route`` names or raises;
a CPU tensor runs the plain version. There is no fallback from one to the
other. Each call that reaches the kernel adds one to
``flash_attention.launches``.

``pipeline_p=True`` (causal only) is B9p, the TPU's software-pipelined
variant (``_flash_kernel_pipe`` :253, ``pallas_call`` at :607): the same
body under its compile-time schedule switch, where step s's scores sit
beside step s−1's pending P·V. It computes the serial walk's rounded
operations in another schedule, so at the same tile its output is the
serial kernel's bitwise (``kernel_route`` gives both the same tile wherever
both fit); its plain version walks the tiles in the pipelined order. Its
launches count in ``flash_attention.pipe_launches``. No model entry point
passes it, as in JAX.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from smmb_tpu_torch.kernels import _build
from smmb_tpu_torch.kernels.flash_decode import LOG2E, MAX_SHARED_BYTES, NEG, _exp2
from smmb_tpu_torch.utils.spans import KERNEL_B9, KERNEL_B9P, span

KV_TILE = 64  # the widest tile of both bodies
TILES = (64, 32, 16)
MMA_HEAD_DIMS = (64, 128)  # the head widths the mma body is built for
MMA_TILE = 64  # its query rows and kv columns
CORE_ROWS = (128, 64, 32, 16)  # query rows a CUDA-core block may own
SMS = 132  # the H100's streaming multiprocessors: row_tile's default


class Route(NamedTuple):
    """The device body a call takes ("mma" or "cuda_core") and its tile."""

    body: str
    tile: int


def shared_bytes(bt: int, hd: int) -> int:
    """Shared memory of the first port's CUDA-core block with ``bt`` query
    rows and kv columns (q and k padded to hd + 1 floats a row, v, p padded
    to bt + 1, the accumulator, m, l and the rescale). It fixes the kv tile
    (``kernel_tile``) of today's body, whose outputs keep that body's bits;
    today's block is ``core_shared_bytes``."""
    return 4 * (2 * bt * (hd + 1) + 2 * bt * hd + bt * (bt + 1) + 3 * bt)


def shared_bytes_pipe(bt: int, hd: int) -> int:
    """Shared memory of the first port's pipelined (B9p) CUDA-core block:
    the serial block and a second (bt, bt + 1) p buffer (``kernel_tile``'s
    rule under ``pipeline_p``)."""
    return shared_bytes(bt, hd) + 4 * bt * (bt + 1)


def shared_bytes_mma(hd: int) -> int:
    """Shared memory of one mma block, serial or pipelined
    (``MmaTile::SMEM``): the bf16 Q tile and two slots each of K and V."""
    return 2 * MMA_TILE * hd * 5


def kernel_tile(hd: int, pipeline_p: bool = False) -> int:
    """The CUDA-core body's kv tile: the widest whose first-port block fits
    shared memory (the pipelined block's under ``pipeline_p``). Frozen
    apart from today's layout: 64 up to hd 193 (pipelined) or 209, 32 up to
    436 or 444, 16 up to 898 or 902, else refused."""
    size = shared_bytes_pipe if pipeline_p else shared_bytes
    for bt in TILES:
        if size(bt, hd) <= MAX_SHARED_BYTES:
            return bt
    raise ValueError(f"head_dim {hd} is too wide for the flash kernel's "
                     "shared memory")


def kernel_route(dtype: torch.dtype, hd: int, pipeline_p: bool = False) -> Route:
    """The body and tile a CUDA call with this dtype, head width and
    schedule takes: the tensor-core body for bf16 at the widths it is built
    for (one tile for both schedules), else the CUDA-core body."""
    if dtype == torch.bfloat16 and hd in MMA_HEAD_DIMS:
        return Route("mma", MMA_TILE)
    return Route("cuda_core", kernel_tile(hd, pipeline_p))


def _core_vectors(dtype: torch.dtype, hd: int) -> int:
    """16-byte vectors of a row of hd elements of ``dtype``."""
    return -(-hd * dtype.itemsize // 16)


def core_shared_bytes(dtype: torch.dtype, hd: int, rows: int, tile: int,
                      k_slots: int = 2) -> int:
    """Shared memory of one CUDA-core block (``core_smem`` in
    csrc/flash_attention.cu): Q as f32 rows of an odd number of 16-byte
    vectors and 16 vectors of skew, ``k_slots`` K slots of ``tile`` rows of
    an odd number of vectors and one V slot in the storage type, and p, f32
    (rows, tile) and 16 vectors of skew."""
    nv = _core_vectors(dtype, hd)
    lq = 4 * ((nv * 16 // dtype.itemsize // 4) | 1)
    return 4 * (rows * lq + 64) + 16 * (k_slots * tile * (nv | 1) + tile * nv) \
        + 4 * (rows * tile + 64)


def core_k_slots(dtype: torch.dtype, hd: int, rows: int, tile: int,
                 pipeline_p: bool = False) -> int | None:
    """K slots of a CUDA-core block (2, or 1 where two do not fit, serial
    only), None where it does not fit at all: the C entry's choice."""
    for k_slots in ((2,) if pipeline_p else (2, 1)):
        if core_shared_bytes(dtype, hd, rows, tile, k_slots) <= MAX_SHARED_BYTES:
            return k_slots
    return None


def core_rows(dtype: torch.dtype, hd: int, pipeline_p: bool = False) -> tuple:
    """The row tiles of ``CORE_ROWS`` the CUDA-core body takes at this
    width, widest first: 16 * SR rows, SR (rows a thread) at most
    64 / (DV * VE) so the accumulator stays in 64 registers (DV: the d
    vectors of a thread, ceil(ceil(hd / VE) / 16) up to a power of two; VE:
    elements of a 16-byte vector), whose block fits shared memory."""
    tile = kernel_tile(hd, pipeline_p)
    need, dv = -(-_core_vectors(dtype, hd) // 16), 1
    while dv < need:
        dv *= 2
    sr_max = 64 // (dv * (16 // dtype.itemsize))
    return tuple(rows for rows in CORE_ROWS if rows // 16 <= sr_max
                 and core_k_slots(dtype, hd, rows, tile, pipeline_p) is not None)


def _largest_divisor_at_most(g: int, cap: int) -> int:
    return next(d for d in range(min(cap, g), 0, -1) if g % d == 0)


def core_blocks(rows: int, b: int, h: int, kvh: int, t: int) -> int:
    """Blocks of a CUDA-core launch with ``rows`` query rows a block: (B,
    KVH, head groups) x q tiles of rows / gb tokens (gb the largest divisor
    of H / KVH that is <= rows)."""
    g = h // kvh
    gb = _largest_divisor_at_most(g, rows)
    return b * kvh * (g // gb) * -(-t // (rows // gb))


def row_tile(dtype: torch.dtype, hd: int, b: int, h: int, kvh: int, t: int,
             pipeline_p: bool = False, sms: int = SMS) -> int:
    """Query rows a CUDA-core block owns for this call: the widest of
    ``core_rows`` whose launch has at least ``sms`` blocks, else the
    narrowest (the most blocks). The kv tile stays ``kernel_tile``'s, and
    every row tile gives the same outputs bitwise."""
    rows = core_rows(dtype, hd, pipeline_p)
    return next((r for r in rows if core_blocks(r, b, h, kvh, t) >= sms), rows[-1])


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _aligned(x):
    """x, or a contiguous copy where the mma body's 16-byte copies could
    not read it in place (a misaligned pointer, or a stride that is not a
    whole number of 8-element pieces)."""
    if x.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in x.stride()[:3]):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _check(q, k, v, causal, window, pipeline_p):
    """JAX's checks (flash_attention.py:456-467)."""
    b, h, t, hd = q.shape
    bk, kvh, s_len, hdk = k.shape
    if (bk, hdk) != (b, hd) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)} vs k {tuple(k.shape)} vs v {tuple(v.shape)}")
    if h % kvh:
        raise ValueError(f"H {h} % KVH {kvh} != 0")
    if window is not None and not causal:
        raise ValueError("window requires causal=True")
    if pipeline_p and not causal:
        raise ValueError("pipeline_p is a causal (triangular-grid) variant")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def _scaled_q(q, scale):
    """q times scale·log2(e) rounded to q's dtype, the product rounded to
    q's dtype (flash_attention.py:109)."""
    return q * torch.tensor(scale * LOG2E, dtype=q.dtype, device=q.device)


def flash_attention_plain(q, k, v, *, causal=True, window=None, scale=None,
                          block_q=None, block_kv=None, pipeline_p=False):
    """B9 in plain PyTorch, on any device: an online softmax over kv tiles
    of ``block_kv`` columns (default the kernel's 64) with the kernel's
    rounding points; the score and P·V products are f64 products rounded
    once to f32. Rows visit every tile up to the last diagonal; a tile that
    is fully masked for a row changes nothing of its result.

    ``pipeline_p`` walks the tiles in B9p's order: step s first adds the
    pending P·V of tile s−1 to ``acc``, then computes tile s's scores, max,
    exp2 and l, multiplies ``acc`` by the rescale and keeps P; a last step
    adds the final P·V. Each value is rounded as in the serial walk
    (``acc * r_s + pv_s``), so the two are equal at the same ``block_kv``."""
    _check(q, k, v, causal, window, pipeline_p)
    b, h, t, hd = q.shape
    kvh, s_len = k.shape[1], k.shape[2]
    g = h // kvh
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    qs = _scaled_q(q, scale).reshape(b, kvh, g * t, hd).to(torch.float64)
    tok = torch.arange(t, device=q.device).repeat(g)  # row (group, token)
    bs = min(block_kv or KV_TILE, s_len)
    ns = -(-s_len // bs)
    if causal:
        ns = min(ns, (t - 1) // bs + 1)
    m = torch.full((b, kvh, g * t), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kvh, g * t, hd), dtype=torch.float32, device=q.device)
    pending = None  # (p, c0, c1) of the tile whose P·V is still to add
    for s in range(ns):
        c0, c1 = s * bs, min((s + 1) * bs, s_len)
        scores = torch.matmul(qs, k[:, :, c0:c1].to(torch.float64).transpose(-1, -2))
        scores = scores.to(torch.float32)
        col = torch.arange(c0, c1, device=q.device)[None, :]
        if causal:
            live = col <= tok[:, None]
            if window is not None:
                live = live & (col > tok[:, None] - window)
            scores = torch.where(live, scores, torch.full_like(scores, NEG))
        scores = scores.contiguous()
        m_new = torch.maximum(m, scores.amax(dim=-1))
        rescale, p = _exp2(m, m_new), _exp2(scores, m_new[..., None])
        l = l * rescale + p.to(torch.float64).sum(dim=-1).to(torch.float32)
        if pipeline_p:
            if pending is not None:
                acc = acc + _pv(pending, v)
            acc = acc * rescale[..., None]
            pending = (p, c0, c1)
        else:
            acc = acc * rescale[..., None] + _pv((p, c0, c1), v)
        m = m_new
    if pending is not None:  # B9p's flush step
        acc = acc + _pv(pending, v)
    out = torch.where(l[..., None] > 0, acc / torch.where(l > 0, l, 1.0)[..., None],
                      torch.zeros_like(acc))
    return out.to(q.dtype).reshape(b, h, t, hd)


def _pv(tile, v):
    """P·V of one kv tile: an f64 product rounded once to f32, P in v's dtype."""
    p, c0, c1 = tile
    return torch.matmul(p.to(v.dtype).to(torch.float64),
                        v[:, :, c0:c1].to(torch.float64)).to(torch.float32)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None, block_q: int | None = None,
                    block_kv: int | None = None,
                    pipeline_p: bool = False, _rows: int | None = None) -> torch.Tensor:
    """Scaled dot-product attention without a (T, S) score tensor.

    q: (B, H, T, hd); k, v: (B, KVH, S, hd), H % KVH == 0 (query head h
    reads KV head h // (H // KVH)); any strides with d contiguous, so head
    views of the projections are read in place. ``causal``: row t attends
    columns ≤ t (and > t − window under ``window``). ``scale`` defaults to
    1/sqrt(hd). ``block_q`` / ``block_kv`` are the TPU kernel's tiles,
    honoured by the plain version (``block_kv``); the CUDA kernel's body
    and tile follow dtype and hd (``kernel_route``). ``pipeline_p``
    (causal only) runs B9p, the pipelined kernel. ``_rows`` forces the
    CUDA-core body's row tile (one of ``core_rows``; checks only).
    Returns (B, H, T, hd) in q's dtype (a head view of a (B, T, H, hd)
    tensor on the card).
    """
    with span(KERNEL_B9P if pipeline_p else KERNEL_B9):
        _check(q, k, v, causal, window, pipeline_p)
        if q.device.type == "cpu":
            return flash_attention_plain(q, k, v, causal=causal, window=window,
                                         scale=scale, block_kv=block_kv,
                                         pipeline_p=pipeline_p)
        if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
            raise ValueError(f"flash_attention runs on cuda or cpu, got {q.device}, "
                             f"{k.device}, {v.device}")
        if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype \
                or v.dtype != q.dtype:
            raise TypeError(f"q, k, v must all be f32 or all bf16, got {q.dtype}, "
                            f"{k.dtype}, {v.dtype}")
        b, h, t, hd = q.shape
        kvh, s_len = k.shape[1], k.shape[2]
        route = kernel_route(q.dtype, hd, pipeline_p)
        if route.body == "mma":
            rows = MMA_TILE
        elif _rows is None:
            rows = row_tile(q.dtype, hd, b, h, kvh, t, pipeline_p, _sms(q.get_device()))
        elif _rows in core_rows(q.dtype, hd, pipeline_p):
            rows = _rows
        else:
            raise ValueError(f"row tile {_rows} not among {core_rows(q.dtype, hd, pipeline_p)}")
        q, k, v = (x if x.stride(3) == 1 else x.contiguous() for x in (q, k, v))
        if route.body == "mma":
            q, k, v = (_aligned(x) for x in (q, k, v))
        if scale is None:
            scale = 1.0 / math.sqrt(hd)
        qscale = torch.tensor(scale * LOG2E, dtype=q.dtype).item()
        out = torch.empty((b, t, h, hd), dtype=q.dtype, device=q.device).permute(0, 2, 1, 3)
        strides = [(ctypes.c_longlong * 3)(*x.stride()[:3]) for x in (q, k, v, out)]
        lib = _build.flash_attention_lib()
        entry = lib.smmb_flash_attention_pipe if pipeline_p else lib.smmb_flash_attention
        with torch.cuda.device(q.device):
            rc = entry(
                q.data_ptr(), strides[0], k.data_ptr(), strides[1], v.data_ptr(),
                strides[2], out.data_ptr(), strides[3], int(q.dtype == torch.bfloat16),
                b, t, s_len, h, kvh, hd, int(causal), window if window is not None else 0,
                qscale, int(route.body == "mma"), route.tile, rows,
                torch.cuda.current_stream(q.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {rc}")
        if pipeline_p:
            flash_attention.pipe_launches += 1
        else:
            flash_attention.launches += 1
        return out


flash_attention.launches = 0
flash_attention.pipe_launches = 0
