"""Flash decode / chunk attention over the flat float KV cache: the
hand-written CUDA kernel B4 and its plain PyTorch version.

Replaces the Pallas TPU kernel of ``smmb_tpu/kernels/flash_decode.py``
(``_decode_kernel``, ``pallas_call`` at :412), which serves the decode step
(``flash_attention_decode``, nq = 1) and the C-token extend chunk
(``flash_attention_chunk``). The kernel is ``csrc/flash_decode.cu``, built
with ``nvcc`` for ``sm_90a`` at first use (``_build.py``) and called through
ctypes: one block per (KV head, batch row) walks the live cache tiles in
ascending order with an online softmax in base 2. A row's result depends on
its own position, S, hd and the window only, never on the other rows of the
call (chunk row c equals the decode step at pos + c, bitwise).

Dispatch: a CUDA tensor launches the kernel or raises; a CPU tensor runs the
plain version. There is no fallback from one to the other. Each call that
reaches the kernel adds one to ``flash_attention_decode.launches`` (the
chunk entry counts there too: it is the same kernel).

The int8 cache (B8: ``flash_attention_decode_quant`` and
``flash_attention_chunk_quant``) belongs to the int8-cache slice of the port.
"""

from __future__ import annotations

import math

import torch

from smmb_tpu_torch.kernels import _build

NEG = -1e30  # a masked score: exp2(NEG - m) underflows to 0
LOG2E = 1.4426950408889634  # the softmax runs in base 2
KV_TILE = 64  # cache columns per tile of the CUDA kernel
MAX_SHARED_BYTES = 232448  # dynamic shared memory a Hopper block may use
INT8_CACHE_SLICE = ("the int8 KV cache needs kernels B7 and B8, which the "
                    "int8-cache slice of the port brings")


def shared_bytes(rows: int, hd: int) -> int:
    """Shared memory of one kernel block holding ``rows`` = nq·(H/KVH) query
    rows: the rows, their scores and accumulators, m, l and the rescale,
    and one K and one V tile of KV_TILE columns, all f32 (``smem_bytes`` in
    csrc/flash_decode.cu)."""
    return 4 * (rows * (2 * hd + KV_TILE + 3) + 2 * KV_TILE * hd)


def flash_chunk_rows_ok(c: int, h: int, hd: int, kvd: int, cache_itemsize: int,
                        compute_itemsize: int = 4) -> bool:
    """Can a C-token chunk of H query heads run through the kernel? Its
    block stages all C·(H/KVH) rows of one KV head in shared memory, so the
    limit is that block's shared memory (at hd = 128: C·g ≤ 129 rows).
    ``cache_itemsize`` and ``compute_itemsize`` are accepted for JAX's
    signature; the kernel stages every value as f32, so neither moves the
    limit. The extend gate (models/attention.attention_extend_core) sends a
    larger chunk to the plain chunk math."""
    kvh = max(1, kvd // hd)
    return shared_bytes(c * (h // kvh), hd) <= MAX_SHARED_BYTES


def _check(q4, kc, vc, compute_dtype):
    """JAX's checks (flash_decode.py:272-299), with its messages. Returns
    (kvh, compute dtype)."""
    b, nq, h, hd = q4.shape
    bk, _, width = kc.shape
    if bk != b or vc.shape != kc.shape:
        raise ValueError(f"q {tuple(q4.shape)} vs kc {tuple(kc.shape)}")
    if hd % 128:
        raise ValueError(f"head_dim {hd} % 128 != 0 — use the jnp path")
    if width % hd:
        raise ValueError(f"cache width {width} not a multiple of hd {hd}")
    kvh = width // hd
    if kvh < 1 or h % kvh:
        raise ValueError(f"H {h} % KVH {kvh} != 0")
    if compute_dtype is not None and not compute_dtype.is_floating_point:
        # the sm_scale*log2e fold shrinks q by ~10x before the cast; an
        # integer compute_dtype would silently round it to near-zero
        raise ValueError(f"compute_dtype must be floating, got {compute_dtype}")
    return kvh, compute_dtype if compute_dtype is not None else kc.dtype


def _exp2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """exp2(a - b) for f32 a, b, taken in f64 and rounded once to f32: the
    same for a row whatever the other rows of the call (torch's vectorised
    f32 exp2 can round a tail element differently)."""
    return torch.exp2(a.to(torch.float64) - b.to(torch.float64)).to(torch.float32)


def _exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as f64 products rounded once to f32 (the exact sum that the
    kernel's f32 accumulation approximates)."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.float32)


def _cache_attention_plain(q4, kc, vc, pos, window, sm_scale, block_kv,
                           compute_dtype):
    """B4 in plain PyTorch: the kernel's tiles, order and rounding points.
    q4 (B, nq, H, hd) → (B, nq, H, hd) in the compute dtype."""
    kvh, cdt = _check(q4, kc, vc, compute_dtype)
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
    top = (pos + nq - 1) // bs
    lo = max(0, (pos - window + 1) // bs) if window is not None else 0
    m = torch.full((b, kvh, nq * g), NEG, dtype=torch.float32, device=q4.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kvh, nq * g, hd), dtype=torch.float32, device=q4.device)
    for t in range(lo, top + 1):
        c0, c1 = t * bs, min((t + 1) * bs, s_len)
        k = kc[:, c0:c1].reshape(b, c1 - c0, kvh, hd).permute(0, 2, 1, 3).to(cdt)
        v = vc[:, c0:c1].reshape(b, c1 - c0, kvh, hd).permute(0, 2, 1, 3).to(cdt)
        scores = _exact(qs, k.transpose(-1, -2))
        col = torch.arange(c0, c1, device=q4.device)[None, :]
        live = col <= row_pos[:, None]
        if window is not None:
            live = live & (col > row_pos[:, None] - window)
        scores = torch.where(live, scores, torch.full_like(scores, NEG)).contiguous()
        m_new = torch.maximum(m, scores.amax(dim=-1))
        rescale, p = _exp2(m, m_new), _exp2(scores, m_new[..., None])
        l = l * rescale + p.to(torch.float64).sum(dim=-1).to(torch.float32)
        acc = acc * rescale[..., None] + _exact(p.to(cdt), v)
        m = m_new
    out = torch.where(l[..., None] > 0, acc / torch.where(l > 0, l, 1.0)[..., None],
                      torch.zeros_like(acc)).to(cdt)
    return out.reshape(b, kvh, nq, g, hd).permute(0, 2, 1, 3, 4).reshape(b, nq, h, hd)


def _cache_attention(q4, kc, vc, pos, window, sm_scale, block_kv, compute_dtype):
    """The shared entry: the plain version for CPU tensors, the kernel for
    CUDA tensors."""
    pos = int(pos)
    if q4.device.type == "cpu":
        return _cache_attention_plain(q4, kc, vc, pos, window, sm_scale, block_kv,
                                      compute_dtype)
    if q4.device.type != "cuda" or kc.device != q4.device or vc.device != q4.device:
        raise ValueError(f"flash attention runs on cuda or cpu, got q on {q4.device} "
                         f"and the cache on {kc.device}")
    kvh, cdt = _check(q4, kc, vc, compute_dtype)
    b, nq, h, hd = q4.shape
    s_len = kc.shape[1]
    if cdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the kernel computes in f32 or bf16, not {cdt}")
    for name, t in (("q", q4), ("kc", kc), ("vc", vc)):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name} must be f32 or bf16, got {t.dtype}")
    if kc.dtype != vc.dtype:
        raise TypeError(f"kc {kc.dtype} and vc {vc.dtype} differ")
    if not (kc.is_contiguous() and vc.is_contiguous()):
        raise ValueError("the flat caches are read in place and must be contiguous")
    if kc.data_ptr() % 16 or vc.data_ptr() % 16:
        raise ValueError("the caches must be 16-byte aligned")
    if pos < 0 or pos + nq > s_len:
        raise ValueError(f"rows at {pos}..{pos + nq - 1} outside the cache of {s_len}")
    rows = nq * (h // kvh)
    if shared_bytes(rows, hd) > MAX_SHARED_BYTES:
        raise ValueError(f"chunk rows {rows} (C={nq}, H={h}) need "
                         f"{shared_bytes(rows, hd)} bytes of shared memory — too "
                         "large for the flash cache kernel; use the chunk math")
    if q4.stride(3) != 1 or q4.stride(2) != hd:
        q4 = q4.contiguous()
    scale = float(sm_scale) if sm_scale is not None else 1.0 / math.sqrt(hd)
    out = torch.empty((b, nq, h, hd), dtype=cdt, device=q4.device)
    lib = _build.flash_decode_lib()
    with torch.cuda.device(q4.device):
        rc = lib.smmb_flash_decode(
            q4.data_ptr(), int(q4.dtype == torch.bfloat16), q4.stride(0), q4.stride(1),
            kc.data_ptr(), vc.data_ptr(), int(kc.dtype == torch.bfloat16),
            out.data_ptr(), b, nq, h, kvh, hd, s_len, pos,
            window if window is not None else 0, scale * LOG2E,
            int(cdt == torch.bfloat16), torch.cuda.current_stream(q4.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error {rc}")
    flash_attention_decode.launches += 1
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
    honoured by the plain version; the CUDA kernel's tile is fixed.
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
                                 block_kv=None, compute_dtype=None):
    """``flash_attention_decode`` in plain PyTorch, on any device."""
    return _cache_attention_plain(q[:, None], kc, vc, int(pos), window, sm_scale,
                                  block_kv, compute_dtype)[:, 0]


def flash_attention_chunk_plain(q, kc, vc, pos, *, window=None, sm_scale=None,
                                block_kv=None, compute_dtype=None):
    """``flash_attention_chunk`` in plain PyTorch, on any device."""
    return _cache_attention_plain(q, kc, vc, int(pos), window, sm_scale, block_kv,
                                  compute_dtype)


def flash_attention_decode_quant(*args, **kwargs):
    raise NotImplementedError(INT8_CACHE_SLICE)


def flash_attention_chunk_quant(*args, **kwargs):
    raise NotImplementedError(INT8_CACHE_SLICE)
