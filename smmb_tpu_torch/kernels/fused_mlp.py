"""Fused packed-ternary kernels of the LM path: the hand-written CUDA kernels
and their plain PyTorch versions.

Replaces the Pallas TPU kernels of ``smmb_tpu/kernels/fused_mlp.py``:

- B3 ``fused_norm_qkv`` (``pallas_call`` at :332): ``rmsnorm(x) · Wqkv``
  times a per-column scale plus a bias, the decode step's head;
- B7 ``fused_norm_qkv_quant`` (:489): B3 with the K and V columns quantized
  to int8 per (row, KV head) in the epilogue, the int8 cache's decode head;
- B6 ``fused_mlp`` (:195): the two-plane MLP, the hidden layer kept out of
  device memory;
- B5 ``fused_block_tail`` (:707): ``wo``, residual, RMSNorm and the MLP of a
  block in one call.

The kernels are ``csrc/fused_mlp.cu``, built with ``nvcc`` for ``sm_90a`` at
first use (``_build.py``) and called through ctypes. Their design (a fixed
split of K over the 8 warps of a block, 32-column product items, the hidden
axis cut into tiles of 128 units with one f32 partial each, summed in tile
order, no atomics) is described in the source. B3 and B7 are one launch of
one item a block (``qkv_blocks``), B7's K/V spans each a thread block
cluster of ``span_cluster(hd)`` blocks that share the span's absmax. B6 and
B5 are one cooperative launch each over as many blocks as fit the card,
walking lists of work items fixed by the shapes (``work_items``) in phases
separated by grid syncs; their workspaces (``workspace_shapes``) come from
here. At the decode shapes every product is bound by the packed weight
bytes.

Dispatch: a CUDA tensor launches the kernel or raises; a CPU tensor runs the
plain version. There is no fallback from one to the other. Each wrapper adds
one to its ``launches`` count per call that reaches its kernel, one CUDA
launch each.
"""

from __future__ import annotations

import math

import torch

from smmb_tpu_torch.formats.packed import GROUP_ROWS, TernaryPacked, decode_words
from smmb_tpu_torch.kernels import _build
from smmb_tpu_torch.ops.dense import prelu
from smmb_tpu_torch.utils.spans import KERNEL_B3, KERNEL_B5, KERNEL_B6, KERNEL_B7, span

FLOAT_DTYPES = (torch.float32, torch.bfloat16)
HIDDEN_TILE = 128  # hidden units per block of the CUDA kernels
ROWS_PER_BLOCK = 8  # activation rows a block stages (1 when M = 1)
MAX_SHARED_BYTES = 232448  # dynamic shared memory a Hopper block may use
WARPS = 8  # a block's warps: the fixed split of K into eighths
ITEM_COLS = 32  # columns of a B5/B6 product item (one a lane)
DOWN_COLS = 256  # output columns of a B5/B6 down item (one a thread)
SUM_COLS = 32  # output columns of a B5/B6 sum item (a warp a row, a lane a column)
PIECE_ROWS = 16  # packed rows of a warp's 16-byte cp.async piece
RING = 4  # pieces a warp keeps in flight
MAX_CLUSTER = 8  # blocks of a B7 K/V span's cluster (the portable most)
HEAD_COLS = 128  # B7's head widths are multiples of 4 items


def shared_bytes(k: int) -> int:
    """The routes' shared-memory formula for activation rows of width ``k``:
    the port's first fused block's (8, k) f32 rows (reused for the 8 warps'
    (8, 128) partial sums), an (8, 128) hidden tile and the norm's scratch.
    It stays the gates' limit; every width it admits fits the blocks of
    today's kernels (``items_shared_bytes``, ``qkv_shared_bytes``)."""
    m = ROWS_PER_BLOCK
    return 4 * (max(m * k, 8 * m * 128) + m * HIDDEN_TILE + m + 8 * m)


def fits_shared(k: int) -> bool:
    """Hopper limit of every fused kernel: its staged rows fit a block's
    shared memory (k ≤ 6656 at 8 rows a block)."""
    return shared_bytes(k) <= MAX_SHARED_BYTES


def item_rows(m: int) -> int:
    """Rows of a row tile of B5's and B6's items: 1 at M = 1, else 8."""
    return 1 if m == 1 else ROWS_PER_BLOCK


def items_shared_bytes(k: int, m: int = ROWS_PER_BLOCK) -> int:
    """Shared memory of one block of B5's and B6's one-launch kernel for
    staged rows of width ``k`` (B5: the larger of A and D): the (rows, k) f32
    rows, the warps' cp.async rings (the partial sums reuse them), and the
    norm's scratch (``items_smem_bytes`` in csrc/fused_mlp.cu)."""
    r = item_rows(m)
    return 4 * (r * k + r + WARPS * r) + WARPS * RING * PIECE_ROWS * ITEM_COLS


def fits_shared_items(k: int, m: int = ROWS_PER_BLOCK) -> bool:
    """The one-launch block's own limit (k ≤ 6656 at 8 rows, as
    ``fits_shared``, which stays the routes' limit and implies this one)."""
    return items_shared_bytes(k, m) <= MAX_SHARED_BYTES


def eighths(k: int) -> list[tuple[int, int]]:
    """The packed rows [p0, p1) of K that each warp of a product item sums,
    in warp order (the fixed split of every fused kernel)."""
    kp = k // 4
    return [(w * kp // WARPS, (w + 1) * kp // WARPS) for w in range(WARPS)]


def work_items(h: int, kout: int, a: int | None = None) -> dict[str, list[tuple]]:
    """The items of one row tile of B6 (``a`` None) or B5 (``a`` = A, ``kout``
    = D), phase by phase, in the order the kernel numbers them: "wo" and
    "up" are product chunks (c0, c1) of columns, each summed by the 8
    ``eighths`` of K; "down" is (hidden tile, c0, c1), and "sum" (c0, c1)
    adds a column's hidden tiles in tile order, columns past ``kout`` cut
    off. A function of the shapes alone: M multiplies the list by its row
    tiles, and the grid only assigns items to blocks."""
    def cut(width):
        return [(c, min(c + width, kout)) for c in range(0, kout, width)]

    return {
        "wo": [] if a is None else [(c, c + ITEM_COLS) for c in range(0, kout, ITEM_COLS)],
        "up": [(c, c + ITEM_COLS) for c in range(0, h, ITEM_COLS)],
        "down": [(t, c0, c1) for t in range(h // HIDDEN_TILE) for c0, c1 in cut(DOWN_COLS)],
        "sum": cut(SUM_COLS),
    }


def most_items(m: int, h: int, kout: int, a: int | None = None) -> int:
    """The largest phase's item count of a call, the grid's cap: the
    lengths of ``work_items``' lists counted without building them (the
    wrapper asks on every call)."""
    per_tile = max(0 if a is None else kout // ITEM_COLS, h // ITEM_COLS,
                   h // HIDDEN_TILE * -(-kout // DOWN_COLS), -(-kout // SUM_COLS))
    return -(-m // item_rows(m)) * per_tile


def workspace_shapes(m: int, h: int, kout: int, tail: bool) -> dict[str, tuple]:
    """The f32 workspaces of a B6 (``tail`` False) or B5 call: the hidden
    layer between the up and down phases, each hidden tile's partial of the
    down product, and B5's residual."""
    shapes = {"up": (m, h), "ws": (h // HIDDEN_TILE, m, kout)}
    if tail:
        shapes["resid"] = (m, kout)
    return shapes


def quant_shared_bytes(d: int, hd: int) -> int:
    """B7's route formula: the port's first B7 block's (8, d) f32 rows, the
    8 warps' (8, 128) partial sums, the (8, hd) f32 y of one head's span,
    and the norm's and the absmax's scratch. It stays the gate's limit and
    implies today's block (``qkv_shared_bytes``)."""
    m = ROWS_PER_BLOCK
    return 4 * (m * d + 8 * m * HIDDEN_TILE + m * hd + 2 * m + 8 * m)


def fits_shared_quant(d: int, hd: int) -> bool:
    """Hopper limit of B7 (d ≤ 6000 at hd 128), in place of JAX's 6 MiB VMEM
    cap on the whole packed plane."""
    return quant_shared_bytes(d, hd) <= MAX_SHARED_BYTES


def span_cluster(head_dim: int) -> int:
    """Blocks of B7's thread block cluster over one K/V span of ``head_dim``
    columns: ``MAX_CLUSTER`` where they split its 32-column items evenly,
    else half (``head_dim`` is a multiple of ``HEAD_COLS``: 4 items)."""
    return MAX_CLUSTER if head_dim // ITEM_COLS % MAX_CLUSTER == 0 else MAX_CLUSTER // 2


def qkv_blocks(d: int, n: int, kv_heads: int | None = None,
               head_dim: int | None = None) -> list[tuple]:
    """The blocks of one row tile of B3 (``kv_heads`` None) or B7, in the
    order of ``blockIdx.x``: ``(slot, rank, chunks)``, where ``chunks`` are
    the (c0, c1) columns of Wqkv the block sums in turn, each by the 8
    ``eighths`` of K. B3's blocks and B7's q blocks: slot None, rank 0, one
    chunk. B7's K/V blocks: slot 2·h + plane (KV head h's k or v span),
    rank j of the span's ``span_cluster`` blocks, the span's j-th share of
    its columns. A function of the shapes alone: M multiplies the list by
    its row tiles."""
    if kv_heads is None:
        return [(None, 0, [(c, c + ITEM_COLS)]) for c in range(0, n, ITEM_COLS)]
    cs = span_cluster(head_dim)
    own = head_dim // cs
    blocks = [(None, 0, [(c, c + ITEM_COLS)]) for c in range(0, d, ITEM_COLS)]
    for slot in range(2 * kv_heads):
        span0 = d + (slot & 1) * kv_heads * head_dim + (slot >> 1) * head_dim
        for rank in range(cs):
            first = span0 + rank * own
            blocks.append((slot, rank, [(c, c + ITEM_COLS)
                                        for c in range(first, first + own, ITEM_COLS)]))
    return blocks


def qkv_shared_bytes(d: int, m: int = ROWS_PER_BLOCK, head_dim: int = 0) -> int:
    """Shared memory of one B3 (``head_dim`` 0) or B7 block for rows of
    width ``d``: ``items_shared_bytes``' rows, rings and scratch, and B7's
    f32 y of the block's ``head_dim / span_cluster`` span columns, its rows'
    scales and the cluster's blocks' absmax of each row (``qkv_smem_bytes``
    in csrc/fused_mlp.cu)."""
    cs = span_cluster(head_dim) if head_dim else 0
    quant = item_rows(m) * (head_dim // cs + 1 + cs) if head_dim else 0
    return items_shared_bytes(d, m) + 4 * quant


def _check_float(name, compute_dtype):
    if compute_dtype not in FLOAT_DTYPES:
        raise ValueError(f"{name} is float-only, got {compute_dtype}")


def _product(a: torch.Tensor, w: TernaryPacked) -> torch.Tensor:
    """``a @ W`` for the plain versions: an f64 product of the f32 (or bf16)
    values and the decoded ±1, rounded once to f32 — the exact sum that the
    kernels' f32 accumulation approximates, in no particular order."""
    wd = decode_words(w.data, torch.float64)[: w.rows]
    return torch.matmul(a.to(torch.float64), wd).to(torch.float32)


def _rms_inv(v: torch.Tensor, eps: float) -> torch.Tensor:
    ms = (v * v).sum(dim=-1, keepdim=True) / v.shape[-1]
    return torch.rsqrt(ms + eps)


def _scalar(s, dev) -> torch.Tensor:
    """A scale as a 0-d f32 tensor on ``dev`` (the kernel reads it there)."""
    if isinstance(s, torch.Tensor):
        return s.to(device=dev, dtype=torch.float32).reshape(())
    return torch.tensor(float(s), dtype=torch.float32, device=dev)


def _vec(v: torch.Tensor, dev) -> torch.Tensor:
    return v.to(device=dev, dtype=torch.float32).contiguous()


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (the kernels read rows
    and the norm gains 16 bytes at a time)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _items_words(w: TernaryPacked, dev) -> torch.Tensor:
    """A plane for the kernels' 16-byte copies: 16-byte aligned, its rows
    padded with zero columns to a multiple of 16 bytes (B3's and B7's N is
    a multiple of 128, so theirs are never padded)."""
    data = w.data
    if data.device != dev or data.dtype != torch.int8:
        raise ValueError("packed planes must be int8 tensors on x's device")
    data = _aligned(data)
    pad = -data.shape[1] % 16
    return torch.nn.functional.pad(data, (0, pad)) if pad else data


def _workspace(m, h, kout, tail, dev) -> tuple[torch.Tensor, dict]:
    """One f32 buffer holding the workspaces of ``workspace_shapes`` (the
    one whose size may not be a multiple of 4 last, so each starts 16-byte
    aligned), and each one's address."""
    shapes = workspace_shapes(m, h, kout, tail)
    sizes = {name: math.prod(shapes[name]) for name in ("resid", "up", "ws") if name in shapes}
    buf = torch.empty(sum(sizes.values()), dtype=torch.float32, device=dev)
    ptrs, at = {}, buf.data_ptr()
    for name, n in sizes.items():
        ptrs[name] = at
        at += 4 * n
    return buf, ptrs


def _check_items_shared(name: str, k: int, m: int) -> None:
    if not fits_shared_items(k, m):
        raise ValueError(f"{name}: rows of width {k} need {items_shared_bytes(k, m)} bytes "
                         f"of shared memory, more than a block's {MAX_SHARED_BYTES}")


_CAPACITY: dict = {}  # (device, B5?, rows a tile, staged width) → blocks that fit at once


def items_grid(m: int, k: int, h: int, kout: int, a: int | None = None,
               device=None) -> int:
    """The grid a B6 (``a`` None) or B5 call (``a`` = A, ``k`` = ``kout`` =
    D) of these shapes takes on the card: the blocks that fit it at once
    (asked of the card once per kernel and width), at most ``most_items``."""
    key = (device, a is not None, item_rows(m), max(k, a or 0))
    blocks = _CAPACITY.get(key)
    if blocks is None:
        with torch.cuda.device(device):
            blocks = _build.fused_mlp_lib().smmb_fused_items_capacity(*key[1:])
        if blocks <= 0:
            raise RuntimeError(f"fused items capacity: CUDA error {-blocks}")
        _CAPACITY[key] = blocks
    return min(blocks, most_items(m, h, kout, a))


def _cuda_call(name: str, x: torch.Tensor, *args) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    fn = getattr(_build.fused_mlp_lib(), f"smmb_{name}")
    with torch.cuda.device(x.device):
        rc = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


# ---------------------------------------------------------------- B3
def _norm_qkv_y(x, norm_g, wqkv, qkv_scale, bqkv, eps, compute_dtype):
    """B3's f32 result: RMSNorm in f32, cast to the compute dtype, the
    product with the decoded plane, scale per column, bias."""
    xf = x.to(torch.float32)
    h = (xf * _rms_inv(xf, eps) * norm_g.to(torch.float32)).to(compute_dtype)
    acc = _product(h, wqkv)
    return acc * qkv_scale.to(torch.float32) + bqkv.to(torch.float32)


def fused_norm_qkv_plain(x, norm_g, wqkv, qkv_scale, bqkv, *, eps,
                         compute_dtype=torch.bfloat16):
    """B3 in plain PyTorch, rounded to x's dtype."""
    return _norm_qkv_y(x, norm_g, wqkv, qkv_scale, bqkv, eps, compute_dtype).to(x.dtype)


def fused_norm_qkv(
    x: torch.Tensor,
    norm_g: torch.Tensor,
    wqkv: TernaryPacked,
    qkv_scale: torch.Tensor,
    bqkv: torch.Tensor,
    *,
    eps: float,
    compute_dtype=torch.bfloat16,
    block_n: int = 1024,
) -> torch.Tensor:
    """``rmsnorm(x, norm_g, eps) @ Wqkv · qkv_scale + bqkv`` in one call.

    x: (M, D) float; wqkv packed (D, N); qkv_scale and bqkv (N,). N need
    not be a power of two (1536 under GQA). Returns (M, N) in x.dtype. A
    row's result does not depend on the other rows of the call.
    ``block_n`` is the TPU kernel's column tile, checked as JAX checks it;
    the CUDA kernel's items are fixed and give the same result.
    """
    with span(KERNEL_B3):
        _check_float("fused_norm_qkv", compute_dtype)
        m, d = x.shape
        kd, n = wqkv.shape
        if kd != d or tuple(norm_g.shape) != (d,):
            raise ValueError(f"x {tuple(x.shape)} / wqkv {wqkv.shape} / g {tuple(norm_g.shape)}")
        if d % GROUP_ROWS:
            raise ValueError(f"D={d} must be a multiple of {GROUP_ROWS}")
        if n % 128 or tuple(qkv_scale.shape) != (n,) or tuple(bqkv.shape) != (n,):
            raise ValueError(f"bad N={n} or scale/bias shapes")
        if block_n <= 0:
            raise ValueError(f"block_n={block_n} must be positive")
        if x.device.type == "cpu":
            return fused_norm_qkv_plain(x, norm_g, wqkv, qkv_scale, bqkv, eps=eps,
                                        compute_dtype=compute_dtype)
        if x.dtype not in FLOAT_DTYPES:
            raise TypeError(f"fused_norm_qkv takes f32 or bf16 x, got {x.dtype}")
        dev = x.device
        xc, g = _aligned(x), _aligned(_vec(norm_g, dev))
        sc, b = _vec(qkv_scale, dev), _vec(bqkv, dev)
        w = _items_words(wqkv, dev)
        out = torch.empty((m, n), dtype=x.dtype, device=dev)
        if m == 0:
            return out
        _cuda_call("fused_norm_qkv", xc, xc.data_ptr(), int(x.dtype == torch.bfloat16),
                   g.data_ptr(), w.data_ptr(), sc.data_ptr(), b.data_ptr(),
                   out.data_ptr(), m, d, n, float(eps),
                   int(compute_dtype == torch.bfloat16))
        fused_norm_qkv.launches += 1
        return out


fused_norm_qkv.launches = 0


# ---------------------------------------------------------------- B7
def quantize_absmax(x: torch.Tensor):
    """(…, hd) float → (int8 codes, f32 scale with hd → 1): ``scale =
    absmax / 127`` and ``codes = round_half_even(x / safe)`` in f32, a zero
    scale dividing by 1 (JAX's rule, smmb_tpu/models/attention.py:365-372 and
    kernels/fused_mlp.py:404-416). Both divisions are tensor by tensor: a
    Python-number divisor becomes a reciprocal multiply on the card, which
    can round a scale differently from IEEE division."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = amax / torch.full_like(amax, 127.0)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    return torch.round(xf / safe).to(torch.int8), scale


def quantize_heads(y: torch.Tensor, d_model: int, kv_heads: int, head_dim: int):
    """The int8 epilogue of B7 on f32 ``y`` (M, d + 2·kv_dim):
    ``quantize_absmax`` per (row, KV head) and plane. Returns codes
    (M, 2·KVH·hd) int8 with KV head h's k at slot 2h and its v at 2h+1, and
    scales (M, 2·KVH) f32 in the same interleave."""
    m = y.shape[0]
    kvd = kv_heads * head_dim
    k = y[:, d_model:d_model + kvd].reshape(m, kv_heads, 1, head_dim)
    v = y[:, d_model + kvd:].reshape(m, kv_heads, 1, head_dim)
    codes, scale = quantize_absmax(torch.cat([k, v], dim=2))  # (M, KVH, 2, ·)
    return codes.reshape(m, 2 * kvd), scale.reshape(m, 2 * kv_heads)


def fused_norm_qkv_quant_plain(x, norm_g, wqkv, qkv_scale, bqkv, *, eps, d_model,
                               kv_heads, head_dim, compute_dtype=torch.bfloat16):
    """B7 in plain PyTorch: B3's f32 y, q rounded to x's dtype, K and V
    quantized from the f32 y."""
    y = _norm_qkv_y(x, norm_g, wqkv, qkv_scale, bqkv, eps, compute_dtype)
    codes, scales = quantize_heads(y, d_model, kv_heads, head_dim)
    return y[:, :d_model].to(x.dtype), codes, scales


def fused_norm_qkv_quant(
    x: torch.Tensor,
    norm_g: torch.Tensor,
    wqkv: TernaryPacked,
    qkv_scale: torch.Tensor,
    bqkv: torch.Tensor,
    *,
    eps: float,
    d_model: int,
    kv_heads: int,
    head_dim: int,
    compute_dtype=torch.bfloat16,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``fused_norm_qkv`` with the int8 cache quantization of K and V in the
    same call: the decode step writes codes with no quantize between kernels.

    x: (M, d_model) float; wqkv packed (d_model, d_model + 2·kv_dim);
    qkv_scale and bqkv (N,). Returns q (M, d_model) in x.dtype (B3's
    columns, bitwise), codes (M, 2·kv_dim) int8 in the per-head [k|v]
    interleave and scales (M, 2·KVH) f32, the K/V quantized from the f32 y
    (``quantize_heads``). A row's result does not depend on the other rows.
    """
    with span(KERNEL_B7):
        if compute_dtype not in FLOAT_DTYPES:
            raise ValueError(f"fused_norm_qkv_quant is float-only, got {compute_dtype}")
        m, d = x.shape
        kd, n = wqkv.shape
        kvd = kv_heads * head_dim
        if kd != d or d != d_model or tuple(norm_g.shape) != (d,):
            raise ValueError(f"x {tuple(x.shape)} / wqkv {wqkv.shape} / g {tuple(norm_g.shape)}")
        if n != d + 2 * kvd:
            raise ValueError(f"N={n} != d_model + 2·kv_dim = {d + 2 * kvd}")
        if d % GROUP_ROWS or head_dim % HEAD_COLS:
            raise ValueError(f"D={d} % {GROUP_ROWS} or head_dim={head_dim} % {HEAD_COLS} != 0")
        if tuple(qkv_scale.shape) != (n,) or tuple(bqkv.shape) != (n,):
            raise ValueError(f"bad scale/bias shapes for N={n}")
        kw = dict(eps=eps, d_model=d_model, kv_heads=kv_heads, head_dim=head_dim,
                  compute_dtype=compute_dtype)
        if x.device.type == "cpu":
            return fused_norm_qkv_quant_plain(x, norm_g, wqkv, qkv_scale, bqkv, **kw)
        if x.dtype not in FLOAT_DTYPES:
            raise TypeError(f"fused_norm_qkv_quant takes f32 or bf16 x, got {x.dtype}")
        dev = x.device
        xc, g = _aligned(x), _aligned(_vec(norm_g, dev))
        sc, b = _vec(qkv_scale, dev), _vec(bqkv, dev)
        w = _items_words(wqkv, dev)
        q = torch.empty((m, d), dtype=x.dtype, device=dev)
        codes = torch.empty((m, 2 * kvd), dtype=torch.int8, device=dev)
        scales = torch.empty((m, 2 * kv_heads), dtype=torch.float32, device=dev)
        if m == 0:
            return q, codes, scales
        _cuda_call("fused_norm_qkv_quant", xc, xc.data_ptr(), int(x.dtype == torch.bfloat16),
                   g.data_ptr(), w.data_ptr(), sc.data_ptr(), b.data_ptr(), q.data_ptr(),
                   codes.data_ptr(), scales.data_ptr(), m, d, n, kv_heads, head_dim,
                   float(eps), int(compute_dtype == torch.bfloat16))
        fused_norm_qkv_quant.launches += 1
        return q, codes, scales


fused_norm_qkv_quant.launches = 0


# ---------------------------------------------------------------- B6
def _mlp_plain(h, w_up, s_up, b_up, w_down, alpha, compute_dtype):
    """The f32 sum of ``PReLU(s_up·(h @ Wup) + b_up) @ Wdown`` for h already
    in the compute dtype, with the hidden layer cast before the second
    product."""
    up = _product(h, w_up) * s_up + b_up.to(torch.float32)
    up = prelu(up, alpha)
    return _product(up.to(compute_dtype), w_down)


def fused_mlp_plain(x, w_up, s_up, b_up, w_down, s_down, b_down, *, alpha,
                    compute_dtype=torch.bfloat16):
    """B6 in plain PyTorch: the scalar scales apply to the f32 sums after
    each product, as in the kernel."""
    acc = _mlp_plain(x.to(compute_dtype), w_up, s_up, b_up, w_down, alpha,
                     compute_dtype)
    return (acc * s_down + b_down.to(torch.float32)).to(x.dtype)


def _check_block_h(block_h: int, h: int) -> None:
    if block_h % GROUP_ROWS:
        raise ValueError(f"block_h={block_h} % {GROUP_ROWS} != 0")
    bh = min(block_h, h)
    if bh <= 0 or h % bh:
        raise ValueError(f"H={h} not a multiple of block_h={bh}")


def fused_mlp(
    x: torch.Tensor,
    w_up: TernaryPacked,
    s_up,
    b_up: torch.Tensor,
    w_down: TernaryPacked,
    s_down,
    b_down: torch.Tensor,
    *,
    alpha: float,
    compute_dtype=torch.bfloat16,
    block_h: int = 1024,
    _grid: int = 0,
) -> torch.Tensor:
    """``prelu(s_up·(X @ Wup) + b_up, alpha) @ Wdown · s_down + b_down`` in
    one call (one launch on the card).

    x: (M, K) float; w_up packed (K, H), w_down packed (H, K_out); s_up and
    s_down scalars (0-d tensors or floats); b_up (H,), b_down (K_out,).
    ``block_h`` is the TPU kernel's hidden slab, checked as JAX checks it;
    the CUDA kernel cuts H into its own tiles of 128 units, which only
    changes the order of the f32 sums. Returns (M, K_out) in x.dtype.
    ``_grid`` forces the launch's block count (0: ``items_grid``), for the
    checks that the result does not depend on it.
    """
    with span(KERNEL_B6):
        _check_float("fused_mlp", compute_dtype)
        m, k = x.shape
        kh, h = w_up.shape
        hd, kout = w_down.shape
        if kh != k or hd != h:
            raise ValueError(f"shape chain {tuple(x.shape)} @ {w_up.shape} @ {w_down.shape}")
        if k % GROUP_ROWS or h % GROUP_ROWS:
            raise ValueError(f"K={k} and H={h} must be multiples of {GROUP_ROWS} "
                             "(use two packed_spmm calls otherwise)")
        _check_block_h(block_h, h)
        if x.device.type == "cpu":
            return fused_mlp_plain(x, w_up, s_up, b_up, w_down, s_down, b_down,
                                   alpha=alpha, compute_dtype=compute_dtype)
        if x.dtype not in FLOAT_DTYPES:
            raise TypeError(f"fused_mlp takes f32 or bf16 x, got {x.dtype}")
        dev = x.device
        xc = _aligned(x)
        su, sd = _scalar(s_up, dev), _scalar(s_down, dev)
        bu, bd = _vec(b_up, dev), _vec(b_down, dev)
        wu, wd = _items_words(w_up, dev), _items_words(w_down, dev)
        out = torch.empty((m, kout), dtype=x.dtype, device=dev)
        if m == 0:
            return out
        _check_items_shared("fused_mlp", k, m)
        buf, ws = _workspace(m, h, kout, False, dev)
        _cuda_call("fused_mlp", xc, xc.data_ptr(), int(x.dtype == torch.bfloat16),
                   wu.data_ptr(), su.data_ptr(), bu.data_ptr(), wd.data_ptr(), wd.shape[1],
                   sd.data_ptr(), bd.data_ptr(), ws["up"], ws["ws"], out.data_ptr(),
                   m, k, h, kout, float(alpha), int(compute_dtype == torch.bfloat16),
                   _grid or items_grid(m, k, h, kout, None, dev))
        fused_mlp.launches += 1
        return out


fused_mlp.launches = 0


# ---------------------------------------------------------------- B5
def fused_block_tail_plain(att, x, wo, s_wo, b_wo, norm2, w_up, s_up, b_up,
                           w_down, s_down, b_down, *, alpha, eps,
                           compute_dtype=torch.bfloat16):
    """B5 in plain PyTorch, in the kernel's order of roundings."""
    wo_acc = _product(att.to(compute_dtype), wo)
    resid = x.to(torch.float32) + wo_acc * s_wo + b_wo.to(torch.float32)
    h2 = resid * _rms_inv(resid, eps) * norm2.to(torch.float32)
    acc = _mlp_plain(h2.to(compute_dtype), w_up, s_up, b_up, w_down, alpha,
                     compute_dtype)
    return (resid + acc * s_down + b_down.to(torch.float32)).to(x.dtype)


def fused_block_tail(
    att: torch.Tensor,
    x: torch.Tensor,
    wo: TernaryPacked,
    s_wo,
    b_wo: torch.Tensor,
    norm2: torch.Tensor,
    w_up: TernaryPacked,
    s_up,
    b_up: torch.Tensor,
    w_down: TernaryPacked,
    s_down,
    b_down: torch.Tensor,
    *,
    alpha: float,
    eps: float,
    compute_dtype=torch.bfloat16,
    block_h: int = 1024,
    _grid: int = 0,
) -> torch.Tensor:
    """The transformer block's tail in one call (one launch on the card)::

        resid = x + s_wo·(att @ Wo) + b_wo
        h     = rmsnorm(resid, norm2, eps)
        up    = prelu(s_up·(h @ Wup) + b_up, alpha)
        out   = resid + s_down·(up @ Wdown) + b_down

    att: (M, A) pre-``wo`` attention mix; x: (M, D) residual stream, read
    in f32. A row's result is bitwise independent of the other rows in the
    call (M = 1 against M = C: the speculative-decoding contract). Returns
    (M, D) in x.dtype. ``_grid`` forces the launch's block count (0:
    ``items_grid``), for the checks that the result does not depend on it.
    """
    with span(KERNEL_B5):
        _check_float("fused_block_tail", compute_dtype)
        m, a = att.shape
        mx, dm = x.shape
        if mx != m or wo.shape != (a, dm):
            raise ValueError(f"att {tuple(att.shape)} / x {tuple(x.shape)} / wo {wo.shape}")
        kd, h = w_up.shape
        if kd != dm or w_down.shape != (h, dm):
            raise ValueError(f"MLP chain {w_up.shape} @ {w_down.shape} vs d_model {dm}")
        if a % GROUP_ROWS or dm % GROUP_ROWS or h % GROUP_ROWS:
            raise ValueError(f"A={a}, D={dm}, H={h} must be multiples of {GROUP_ROWS}")
        _check_block_h(block_h, h)
        if x.device.type == "cpu":
            return fused_block_tail_plain(
                att, x, wo, s_wo, b_wo, norm2, w_up, s_up, b_up, w_down, s_down,
                b_down, alpha=alpha, eps=eps, compute_dtype=compute_dtype)
        if x.dtype not in FLOAT_DTYPES or att.dtype not in FLOAT_DTYPES:
            raise TypeError(f"fused_block_tail takes f32 or bf16 att and x, got "
                            f"{att.dtype} and {x.dtype}")
        dev = x.device
        attc, xc = _aligned(att), _aligned(x)
        if attc.device != dev:
            raise ValueError("att must be on x's device")
        swo, su, sd = _scalar(s_wo, dev), _scalar(s_up, dev), _scalar(s_down, dev)
        bwo, g2 = _vec(b_wo, dev), _aligned(_vec(norm2, dev))
        bu, bd = _vec(b_up, dev), _vec(b_down, dev)
        wod, wu, wd = (_items_words(w, dev) for w in (wo, w_up, w_down))
        out = torch.empty((m, dm), dtype=x.dtype, device=dev)
        if m == 0:
            return out
        _check_items_shared("fused_block_tail", max(a, dm), m)
        buf, ws = _workspace(m, h, dm, True, dev)
        ptrs = [t.data_ptr() for t in (wod, swo, bwo, g2, wu, su, bu, wd, sd, bd)]
        _cuda_call("fused_block_tail", xc, attc.data_ptr(), int(att.dtype == torch.bfloat16),
                   xc.data_ptr(), int(x.dtype == torch.bfloat16), *ptrs, ws["resid"], ws["up"],
                   ws["ws"], out.data_ptr(), m, a, dm, h, float(alpha), float(eps),
                   int(compute_dtype == torch.bfloat16), _grid or items_grid(m, dm, h, dm, a, dev))
        fused_block_tail.launches += 1
        return out


fused_block_tail.launches = 0
