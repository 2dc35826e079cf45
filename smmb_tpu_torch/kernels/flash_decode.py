"""Flash decode / chunk attention over the flat KV cache: the hand-written
CUDA kernels B4 (float cache) and B8 (merged int8 cache) and their plain
PyTorch version.

Replaces the Pallas TPU kernel of ``smmb_tpu/kernels/flash_decode.py``
(``_decode_kernel``, ``pallas_call`` at :412), which serves the decode step
(``flash_attention_decode``, nq = 1), the C-token extend chunk
(``flash_attention_chunk``) and, in its quant arms, both over the int8 cache
(``flash_attention_decode_quant``, ``flash_attention_chunk_quant``). The
kernel is ``csrc/flash_decode.cu``, built with ``nvcc`` for ``sm_90a`` at
first use (``_build.py``) and called through ctypes. It splits the live
cache into spans of ``split_cols(S)`` columns, cut at absolute multiples of
the span and so a function of S alone, and launches one block per (live
span, KV head, batch row): each walks its span's tiles in ascending order
with an online softmax in base 2 and writes its partial (m, l, acc); the
last block of a (batch row, KV head) to finish combines the spans in
ascending order, in the same launch. A row's result depends on its own
position, S, hd and the window only, never on the other rows of the call
(chunk row c equals the decode step at pos + c, bitwise). The int8 mode is
the same walk over int8 tiles: codes cast to the compute dtype as they are
read, each score times its column's k scale after QKᵀ, and p times the
column's v scale before P·V (``l`` sums p before that multiply).

The wrapper owns the kernel's buffers: a ``torch.empty`` workspace for the
partials, sized by the live spans, and a per-device int32 counter buffer,
zeroed once when made and left zeroed by the combining blocks. The
counters assume that the kernel's launches on a device come in order on
one stream (the caller's current stream); two launches running at once on
two streams could share a counter.

Dispatch: a CUDA tensor launches the kernel or raises; a CPU tensor runs the
plain version. There is no fallback from one to the other. Each call that
reaches the float kernel adds one to ``flash_attention_decode.launches``,
each that reaches the int8 kernel one to
``flash_attention_decode_quant.launches`` (the chunk entries count with
their decode entries: each pair is one kernel).
"""

from __future__ import annotations

import math

import torch

from smmb_tpu_torch.kernels import _build
from smmb_tpu_torch.utils.spans import KERNEL_B4, KERNEL_B8, span

NEG = -1e30  # a masked score: exp2(NEG - m) underflows to 0
LOG2E = 1.4426950408889634  # the softmax runs in base 2
KV_TILE = 64  # cache columns per tile of the CUDA kernel
MAX_SPLITS = 32  # spans of one cache at most (split_cols)
KV_RING = 2  # K/V copy slots of a kernel block (one where two do not fit)
MAX_SHARED_BYTES = 232448  # dynamic shared memory a Hopper block may use


def split_cols(s_len: int) -> int:
    """Columns of one span of an S-column cache: KV_TILE·⌈⌈S/KV_TILE⌉ /
    MAX_SPLITS⌉, at most MAX_SPLITS spans. A function of S alone, never of
    the position, the window, the chunk, the batch or the device: a chunk
    row and the decode step at its position see the same spans, and so the
    same sums."""
    tiles = -(-s_len // KV_TILE)
    return KV_TILE * -(-tiles // MAX_SPLITS)


def live_spans(pos: int, nq: int, window: int | None, span: int) -> tuple[int, int]:
    """(first, count) of the spans a call reads: from the span holding token
    0's window edge (column 0 without a window) to the one holding column
    pos + nq - 1. The kernel's grid is (count, KVH, B)."""
    edge = pos - window + 1 if window else 0
    first = max(edge, 0) // span
    return first, (pos + nq - 1) // span - first + 1


def shared_bytes(rows: int, hd: int, quant: bool = False) -> int:
    """Shared memory of the first kernel's block (one unsplit K/V walk,
    every value staged as f32) holding ``rows`` = nq·(H/KVH) query rows: the
    rows, their scores and accumulators, m, l and the rescale, one K and one
    V tile of KV_TILE columns and, in the int8 mode, the tile's KV_TILE k
    and v scales, all f32. It stays the extend route's limit
    (``flash_chunk_rows_ok``), so that the route is unchanged; the split
    kernel's own block (``kernel_shared_bytes``) fits every chunk it
    admits."""
    scales = 2 * KV_TILE if quant else 0
    return 4 * (rows * (2 * hd + KV_TILE + 3) + 2 * KV_TILE * hd + scales)


def ring_slots(rows: int, hd: int, itemsize: int, quant: bool = False) -> int:
    """Slots of the kernel's K/V copy ring: KV_RING where they fit, else one."""
    fits = kernel_shared_bytes(rows, hd, itemsize, quant, KV_RING) <= MAX_SHARED_BYTES
    return KV_RING if fits else 1


def kernel_shared_bytes(rows: int, hd: int, itemsize: int, quant: bool = False,
                        slots: int | None = None) -> int:
    """Shared memory of one block of the split kernel (``smem_bytes`` in
    csrc/flash_decode.cu): ``slots`` ring slots (default ``ring_slots``),
    each a K and a V tile of KV_TILE columns in the cache's ``itemsize``
    and, in the int8 mode, the tile's f32 k and v scales; then, in f32,
    the query rows, their accumulators and scores, m, l and the rescale."""
    if slots is None:
        slots = ring_slots(rows, hd, itemsize, quant)
    slot = 2 * KV_TILE * hd * itemsize + (2 * KV_TILE * 4 if quant else 0)
    return slots * slot + 4 * rows * (2 * hd + KV_TILE + 3)


def flash_chunk_rows_ok(c: int, h: int, hd: int, kvd: int, cache_itemsize: int,
                        compute_itemsize: int = 4) -> bool:
    """Can a C-token chunk of H query heads run through the kernel? Its
    block stages all C·(H/KVH) rows of one KV head in shared memory. The
    limit is the first kernel's block (``shared_bytes``, at hd = 128:
    C·g ≤ 129 rows over a float cache, ≤ 128 over the int8 cache), kept as
    the route's limit so that the extend route is what it was; the split
    kernel's block fits every chunk it admits (with one ring slot where two
    do not fit), and widening the route to that block's own limit is an
    open question (ROADMAP).
    ``kvd`` is the cache's last width as JAX passes it: KVH·hd for a float
    cache, 2·KVH·hd for the merged int8 cache, which is the one with
    ``cache_itemsize`` 1. ``compute_itemsize`` is accepted for JAX's
    signature; it does not move the limit. The extend gate
    (models/attention.attention_extend_core) sends a larger chunk to the
    plain chunk math."""
    quant = cache_itemsize == 1
    kvh = max(1, kvd // (2 * hd if quant else hd))
    return shared_bytes(c * (h // kvh), hd, quant) <= MAX_SHARED_BYTES


def _check(q4, kc, vc, compute_dtype, kv_scale=None):
    """JAX's checks (flash_decode.py:272-299), with its messages. ``kv_scale``
    selects the merged int8 mode (``kc`` the codes, ``vc`` None). Returns
    (kvh, compute dtype): the default is the cache's dtype, q's in the int8
    mode (flash_decode.py:304)."""
    quant = kv_scale is not None
    b, nq, h, hd = q4.shape
    bk, s_len, width = kc.shape
    if bk != b or (not quant and vc.shape != kc.shape):
        raise ValueError(f"q {tuple(q4.shape)} vs kc {tuple(kc.shape)}")
    if hd % 128:
        raise ValueError(f"head_dim {hd} % 128 != 0 — use the jnp path")
    if width % hd:
        raise ValueError(f"cache width {width} not a multiple of hd {hd}")
    kvh = width // (2 * hd) if quant else width // hd
    if kvh < 1 or h % kvh:
        raise ValueError(f"H {h} % KVH {kvh} != 0")
    if quant:
        if vc is not None or kc.dtype != torch.int8:
            raise ValueError("merged-quant mode takes int8 codes and no separate v")
        if tuple(kv_scale.shape) != (b, 2 * kvh, s_len):
            raise ValueError(
                f"kv_scale must be (B, 2·KVH, S)=({b}, {2 * kvh}, {s_len}) "
                f"as stored by init_kv_cache, got {tuple(kv_scale.shape)}")
    if compute_dtype is not None and not compute_dtype.is_floating_point:
        # the sm_scale*log2e fold shrinks q by ~10x before the cast; an
        # integer compute_dtype would silently round it to near-zero
        raise ValueError(f"compute_dtype must be floating, got {compute_dtype}")
    if compute_dtype is None:
        compute_dtype = q4.dtype if quant else kc.dtype
    return kvh, compute_dtype


def _exp2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """exp2(a - b) for f32 a, b, taken in f64 and rounded once to f32: the
    same for a row whatever the other rows of the call (torch's vectorised
    f32 exp2 can round a tail element differently)."""
    return torch.exp2(a.to(torch.float64) - b.to(torch.float64)).to(torch.float32)


def _exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as f64 products rounded once to f32 (the exact sum that the
    kernel's f32 accumulation approximates)."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.float32)


def _tiles(kc, vc, kv_scale, c0, c1, kvh, hd, cdt):
    """Columns c0..c1-1 of the cache as (B, KVH, n, hd) K and V tiles in the
    compute dtype, and (B, KVH, n) f32 k and v scales (None for a float
    cache). The merged int8 row holds KV head h's k codes at slot 2h and its
    v codes at slot 2h+1; every code is exact in the compute dtype."""
    b, n = kc.shape[0], c1 - c0
    if kv_scale is None:
        k = kc[:, c0:c1].reshape(b, n, kvh, hd)
        v = vc[:, c0:c1].reshape(b, n, kvh, hd)
        ks = vs = None
    else:
        kv = kc[:, c0:c1].reshape(b, n, kvh, 2, hd)
        k, v = kv[:, :, :, 0], kv[:, :, :, 1]
        sc = kv_scale[:, :, c0:c1].reshape(b, kvh, 2, n)
        ks, vs = sc[:, :, 0], sc[:, :, 1]
    return (k.permute(0, 2, 1, 3).to(cdt), v.permute(0, 2, 1, 3).to(cdt), ks, vs)


def _cache_attention_plain(q4, kc, vc, pos, window, sm_scale, block_kv,
                           compute_dtype, kv_scale=None, *, split_cols=None):
    """B4 (and B8, given ``kv_scale``) in plain PyTorch: the kernel's spans,
    tiles, order and rounding points. Each span of ``split_cols`` columns
    (default: the kernel's, a function of S) walks its tiles of
    ``block_kv`` columns (default the kernel's KV_TILE) from its own first
    column; the spans' partial states are then combined in ascending order.
    q4 (B, nq, H, hd) → (B, nq, H, hd) in the compute dtype."""
    kvh, cdt = _check(q4, kc, vc, compute_dtype, kv_scale)
    b, nq, h, hd = q4.shape
    s_len = kc.shape[1]
    if pos < 0 or pos + nq > s_len:
        raise ValueError(f"rows at {pos}..{pos + nq - 1} outside the cache of {s_len}")
    g = h // kvh
    scale = float(sm_scale) if sm_scale is not None else 1.0 / math.sqrt(hd)
    qs = (q4.to(torch.float32) * (scale * LOG2E)).to(cdt)
    # rows ordered (token, group) under each KV head: (B, KVH, nq·g, hd)
    qs = qs.reshape(b, nq, kvh, g, hd).permute(0, 2, 1, 3, 4).reshape(b, kvh, nq * g, hd)
    row_pos = pos + torch.arange(nq * g, device=q4.device) // g
    bs = min(block_kv or KV_TILE, s_len)
    span = _span(s_len, split_cols)
    top = pos + nq - 1
    edge = max(0, pos - window + 1) if window else 0
    first, count = live_spans(pos, nq, window, span)
    parts = []
    for j in range(first, first + count):
        m = torch.full((b, kvh, nq * g), NEG, dtype=torch.float32, device=q4.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, kvh, nq * g, hd), dtype=torch.float32, device=q4.device)
        end = min((j + 1) * span, s_len)
        for c0 in range(j * span, end, bs):
            c1 = min(c0 + bs, end)
            if c1 <= edge or c0 > top:  # outside the launch's live tiles
                continue
            k, v, k_scale, v_scale = _tiles(kc, vc, kv_scale, c0, c1, kvh, hd, cdt)
            scores = _exact(qs, k.transpose(-1, -2))
            if k_scale is not None:  # per column, after QKᵀ (commutes with the fold)
                scores = scores * k_scale[:, :, None, :]
            col = torch.arange(c0, c1, device=q4.device)[None, :]
            live = col <= row_pos[:, None]
            if window is not None:
                live = live & (col > row_pos[:, None] - window)
            scores = torch.where(live, scores, torch.full_like(scores, NEG)).contiguous()
            m_new = torch.maximum(m, scores.amax(dim=-1))
            rescale, p = _exp2(m, m_new), _exp2(scores, m_new[..., None])
            l = l * rescale + p.to(torch.float64).sum(dim=-1).to(torch.float32)
            if v_scale is not None:  # l sums p before the v scale
                p = p * v_scale[:, :, None, :]
            acc = acc * rescale[..., None] + _exact(p.to(cdt), v)
            m = m_new
        parts.append((m, l, acc))
    # the combine, in ascending span order: a span with no live column for a
    # row has m = NEG there, weight exp2(NEG - M) = 0, and adds exact zeros
    big_m = torch.stack([p[0] for p in parts]).amax(dim=0)
    l = torch.zeros_like(big_m)
    acc = torch.zeros_like(parts[0][2])
    for m_j, l_j, acc_j in parts:
        w = _exp2(m_j, big_m)
        l = l + l_j * w
        acc = acc + acc_j * w[..., None]
    out = torch.where(l[..., None] > 0, acc / torch.where(l > 0, l, 1.0)[..., None],
                      torch.zeros_like(acc)).to(cdt)
    return out.reshape(b, kvh, nq, g, hd).permute(0, 2, 1, 3, 4).reshape(b, nq, h, hd)


def _span(s_len: int, cols: int | None) -> int:
    """The span of the plain version: ``cols`` if given, else the kernel's."""
    if cols is None:
        return split_cols(s_len)
    if cols <= 0:
        raise ValueError(f"split_cols must be positive, got {cols}")
    return int(cols)


_COUNTERS: dict = {}  # device → the kernel's int32 (batch row, KV head) counters


def _counters(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 counters on ``device``: made once, grown
    (zeroed anew) when a call has more (batch row, KV head) pairs; the
    combining blocks leave them zeroed."""
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        _COUNTERS[device] = buf
    return buf


def _cache_attention(q4, kc, vc, pos, window, sm_scale, block_kv, compute_dtype,
                     kv_scale=None):
    """The shared entry: the plain version for CPU tensors, the kernel for
    CUDA tensors (the float kernel B4, or B8 given ``kv_scale``)."""
    pos = int(pos)
    quant = kv_scale is not None
    with span(KERNEL_B8 if quant else KERNEL_B4):
        if q4.device.type == "cpu":
            return _cache_attention_plain(q4, kc, vc, pos, window, sm_scale, block_kv,
                                          compute_dtype, kv_scale)
        bufs = (kc, kv_scale) if quant else (kc, vc)
        if q4.device.type != "cuda" or any(t.device != q4.device for t in bufs):
            raise ValueError(f"flash attention runs on cuda or cpu, got q on {q4.device} "
                             f"and the cache on {kc.device}")
        kvh, cdt = _check(q4, kc, vc, compute_dtype, kv_scale)
        b, nq, h, hd = q4.shape
        s_len = kc.shape[1]
        if cdt not in (torch.float32, torch.bfloat16):
            raise TypeError(f"the kernel computes in f32 or bf16, not {cdt}")
        for name, t in (("q", q4),) if quant else (("q", q4), ("kc", kc), ("vc", vc)):
            if t.dtype not in (torch.float32, torch.bfloat16):
                raise TypeError(f"{name} must be f32 or bf16, got {t.dtype}")
        if quant and kv_scale.dtype != torch.float32:
            raise TypeError(f"kv_scale must be f32, got {kv_scale.dtype}")
        if not quant and kc.dtype != vc.dtype:
            raise TypeError(f"kc {kc.dtype} and vc {vc.dtype} differ")
        if not all(t.is_contiguous() for t in bufs):
            raise ValueError("the flat caches are read in place and must be contiguous")
        if any(t.data_ptr() % 16 for t in bufs):
            raise ValueError("the caches must be 16-byte aligned")
        if pos < 0 or pos + nq > s_len:
            raise ValueError(f"rows at {pos}..{pos + nq - 1} outside the cache of {s_len}")
        rows = nq * (h // kvh)
        if shared_bytes(rows, hd, quant) > MAX_SHARED_BYTES:
            raise ValueError(f"chunk rows {rows} (C={nq}, H={h}) need "
                             f"{shared_bytes(rows, hd, quant)} bytes of shared memory — too "
                             "large for the flash cache kernel; use the chunk math")
        need = kernel_shared_bytes(rows, hd, kc.element_size(), quant)
        if need > MAX_SHARED_BYTES:
            raise ValueError(f"chunk rows {rows} (C={nq}, H={h}) need {need} bytes of shared "
                             "memory in the split kernel's block")
        if q4.stride(3) != 1 or q4.stride(2) != hd:
            q4 = q4.contiguous()
        scale = float(sm_scale) if sm_scale is not None else 1.0 / math.sqrt(hd)
        out = _launch(q4, kc, vc, kv_scale, pos, window, scale, cdt, kvh, split_cols(s_len))
        if quant:
            flash_attention_decode_quant.launches += 1
        else:
            flash_attention_decode.launches += 1
        return out


def _launch(q4, kc, vc, kv_scale, pos, window, scale, cdt, kvh, span):
    """One launch of the CUDA kernel on inputs ``_cache_attention`` checked,
    over spans of ``span`` columns (the wrapper's: ``split_cols(S)``; the
    span sweep of bench/decode_spans.py passes others). Allocates the
    output and the workspace; counts nothing."""
    quant = kv_scale is not None
    b, nq, h, hd = q4.shape
    s_len = kc.shape[1]
    _, nspans = live_spans(pos, nq, window, span)
    out = torch.empty((b, nq, h, hd), dtype=cdt, device=q4.device)
    # the spans' partial (acc, m, l) in f32, and the (b, KV head) counters
    ws = torch.empty(b * kvh * nspans * nq * (h // kvh) * (hd + 2), dtype=torch.float32,
                     device=q4.device)
    bufs = (out.data_ptr(), ws.data_ptr(), _counters(q4.device, b * kvh).data_ptr())
    lib = _build.flash_decode_lib()
    q_args = (q4.data_ptr(), int(q4.dtype == torch.bfloat16), q4.stride(0), q4.stride(1))
    shape = (b, nq, h, kvh, hd, s_len, pos, window if window is not None else 0, span,
             nspans, scale * LOG2E, int(cdt == torch.bfloat16))
    with torch.cuda.device(q4.device):
        stream = torch.cuda.current_stream(q4.device).cuda_stream
        if quant:
            rc = lib.smmb_flash_decode_quant(*q_args, kc.data_ptr(), kv_scale.data_ptr(),
                                             *bufs, *shape, stream)
        else:
            rc = lib.smmb_flash_decode(*q_args, kc.data_ptr(), vc.data_ptr(),
                                       int(kc.dtype == torch.bfloat16), *bufs, *shape,
                                       stream)
    if rc != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error {rc}")
    return out


def flash_attention_decode(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                           pos: int, *, window: int | None = None,
                           sm_scale: float | None = None,
                           block_kv: int | None = None,
                           compute_dtype=None) -> torch.Tensor:
    """One-token attention over the flat float cache, reading only the live
    prefix (and window).

    q: (B, H, hd), the token at position ``pos`` (its own K/V already
    written); kc, vc: (B, S, KVH·hd) flat caches, read in place; query head
    h reads KV head h // (H // KVH). ``block_kv`` is the TPU kernel's tile,
    honoured by the plain version; the CUDA kernel's tile is fixed, and its
    spans are ``split_cols(S)`` columns.
    Returns (B, H, hd) in the compute dtype (default: the cache's).
    """
    return _cache_attention(q[:, None], kc, vc, pos, window, sm_scale, block_kv,
                            compute_dtype)[:, 0]


flash_attention_decode.launches = 0


def flash_attention_chunk(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                          pos: int, *, window: int | None = None,
                          sm_scale: float | None = None,
                          block_kv: int | None = None,
                          compute_dtype=None) -> torch.Tensor:
    """C-token chunk attention over the flat float cache: q (B, C, H, hd),
    the chunk already written at pos..pos+C-1; row c attends columns
    ≤ pos + c (window-clipped). The same kernel as the decode step, so
    row c equals ``flash_attention_decode`` at pos + c bitwise. Returns
    (B, C, H, hd) in the compute dtype."""
    return _cache_attention(q, kc, vc, pos, window, sm_scale, block_kv, compute_dtype)


def flash_attention_decode_plain(q, kc, vc, pos, *, window=None, sm_scale=None,
                                 block_kv=None, compute_dtype=None, split_cols=None):
    """``flash_attention_decode`` in plain PyTorch, on any device
    (``split_cols`` overrides the span, default the kernel's)."""
    return _cache_attention_plain(q[:, None], kc, vc, int(pos), window, sm_scale,
                                  block_kv, compute_dtype, split_cols=split_cols)[:, 0]


def flash_attention_chunk_plain(q, kc, vc, pos, *, window=None, sm_scale=None,
                                block_kv=None, compute_dtype=None, split_cols=None):
    """``flash_attention_chunk`` in plain PyTorch, on any device."""
    return _cache_attention_plain(q, kc, vc, int(pos), window, sm_scale, block_kv,
                                  compute_dtype, split_cols=split_cols)


def flash_attention_decode_quant(q: torch.Tensor, kv: torch.Tensor,
                                 kv_scale: torch.Tensor, pos: int, *,
                                 window: int | None = None,
                                 sm_scale: float | None = None,
                                 block_kv: int | None = None,
                                 compute_dtype=None) -> torch.Tensor:
    """``flash_attention_decode`` over the merged int8 cache (B8): ``kv``
    (B, S, 2·KVH·hd) int8 codes with KV head h's k at slot 2h and its v at
    slot 2h+1, ``kv_scale`` (B, 2·KVH, S) f32 absmax scales in the same
    interleave, as ``models/attention.init_kv_cache(quantized=True)`` stores
    them. The codes are read as int8 and cast on the card. The default
    compute dtype is q's. Returns (B, H, hd) in the compute dtype."""
    return _cache_attention(q[:, None], kv, None, pos, window, sm_scale, block_kv,
                            compute_dtype, kv_scale)[:, 0]


flash_attention_decode_quant.launches = 0


def flash_attention_chunk_quant(q: torch.Tensor, kv: torch.Tensor,
                                kv_scale: torch.Tensor, pos: int, *,
                                window: int | None = None,
                                sm_scale: float | None = None,
                                block_kv: int | None = None,
                                compute_dtype=None) -> torch.Tensor:
    """``flash_attention_chunk`` over the merged int8 cache (see
    ``flash_attention_decode_quant``; the same kernel, so row c equals the
    int8 decode step at pos + c bitwise). Returns (B, C, H, hd)."""
    return _cache_attention(q, kv, None, pos, window, sm_scale, block_kv,
                            compute_dtype, kv_scale)


def flash_attention_decode_quant_plain(q, kv, kv_scale, pos, *, window=None,
                                       sm_scale=None, block_kv=None,
                                       compute_dtype=None, split_cols=None):
    """``flash_attention_decode_quant`` in plain PyTorch, on any device."""
    return _cache_attention_plain(q[:, None], kv, None, int(pos), window, sm_scale,
                                  block_kv, compute_dtype, kv_scale,
                                  split_cols=split_cols)[:, 0]


def flash_attention_chunk_quant_plain(q, kv, kv_scale, pos, *, window=None,
                                      sm_scale=None, block_kv=None, compute_dtype=None,
                                      split_cols=None):
    """``flash_attention_chunk_quant`` in plain PyTorch, on any device."""
    return _cache_attention_plain(q, kv, None, int(pos), window, sm_scale, block_kv,
                                  compute_dtype, kv_scale, split_cols=split_cols)
