"""Fused packed-ternary kernels of the LM path: the hand-written CUDA kernels
and their plain PyTorch versions.

Replaces the Pallas TPU kernels of ``smmb_tpu/kernels/fused_mlp.py``:

- B3 ``fused_norm_qkv`` (``pallas_call`` at :332): ``rmsnorm(x) · Wqkv``
  times a per-column scale plus a bias, the decode step's head;
- B6 ``fused_mlp`` (:195): the two-plane MLP, the hidden layer kept out of
  device memory;
- B5 ``fused_block_tail`` (:707): ``wo``, residual, RMSNorm and the MLP of a
  block in one call.

The kernels are ``csrc/fused_mlp.cu``, built with ``nvcc`` for ``sm_90a`` at
first use (``_build.py``) and called through ctypes. Their design (a fixed
split of K over the 8 warps of a block, the hidden axis cut into tiles of 128
units with one f32 partial each, summed in tile order by a second launch, no
atomics) is described in the source. At the decode shapes every product is
bound by the packed weight bytes.

Dispatch: a CUDA tensor launches the kernel or raises; a CPU tensor runs the
plain version. There is no fallback from one to the other. Each wrapper adds
one to its ``launches`` count per call that reaches its kernel (B6 and B5
are two and three CUDA launches under one call).
"""

from __future__ import annotations

import torch

from smmb_tpu_torch.formats.packed import GROUP_ROWS, TernaryPacked, decode_words
from smmb_tpu_torch.kernels import _build
from smmb_tpu_torch.ops.dense import prelu

FLOAT_DTYPES = (torch.float32, torch.bfloat16)
HIDDEN_TILE = 128  # hidden units per block of the CUDA kernels
ROWS_PER_BLOCK = 8  # activation rows a block stages (1 when M = 1)
MAX_SHARED_BYTES = 232448  # dynamic shared memory a Hopper block may use


def shared_bytes(k: int) -> int:
    """Shared memory of one block of the kernels for activation rows of
    width ``k``: the (8, k) f32 rows (reused for the 8 warps' (8, 128)
    partial sums), the (8, 128) hidden tile, and the norm's scratch
    (``smem_bytes`` in csrc/fused_mlp.cu)."""
    m = ROWS_PER_BLOCK
    return 4 * (max(m * k, 8 * m * 128) + m * HIDDEN_TILE + m + 8 * m)


def fits_shared(k: int) -> bool:
    """Hopper limit of every fused kernel: its staged rows fit a block's
    shared memory (k ≤ 6656 at 8 rows a block)."""
    return shared_bytes(k) <= MAX_SHARED_BYTES


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


def _words(w: TernaryPacked, dev) -> torch.Tensor:
    data = w.data
    if data.device != dev or data.dtype != torch.int8:
        raise ValueError("packed planes must be int8 tensors on x's device")
    data = data.contiguous()
    return data if data.data_ptr() % 4 == 0 else data.clone()


def _cuda_call(name: str, x: torch.Tensor, *args) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    fn = getattr(_build.fused_mlp_lib(), f"smmb_{name}")
    with torch.cuda.device(x.device):
        rc = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


# ---------------------------------------------------------------- B3
def fused_norm_qkv_plain(x, norm_g, wqkv, qkv_scale, bqkv, *, eps,
                         compute_dtype=torch.bfloat16):
    """B3 in plain PyTorch: RMSNorm in f32, cast to the compute dtype, the
    product with the decoded plane, scale per column, bias."""
    xf = x.to(torch.float32)
    h = (xf * _rms_inv(xf, eps) * norm_g.to(torch.float32)).to(compute_dtype)
    acc = _product(h, wqkv)
    y = acc * qkv_scale.to(torch.float32) + bqkv.to(torch.float32)
    return y.to(x.dtype)


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
    the CUDA kernel's tile is fixed and gives the same result.
    """
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
    xc, g = x.contiguous(), _vec(norm_g, dev)
    sc, b = _vec(qkv_scale, dev), _vec(bqkv, dev)
    w = _words(wqkv, dev)
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
) -> torch.Tensor:
    """``prelu(s_up·(X @ Wup) + b_up, alpha) @ Wdown · s_down + b_down`` in
    one call; the (M, H) hidden layer never reaches device memory.

    x: (M, K) float; w_up packed (K, H), w_down packed (H, K_out); s_up and
    s_down scalars (0-d tensors or floats); b_up (H,), b_down (K_out,).
    ``block_h`` is the TPU kernel's hidden slab, checked as JAX checks it;
    the CUDA kernel cuts H into its own tiles of 128 units, which only
    changes the order of the f32 sums. Returns (M, K_out) in x.dtype.
    """
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
    xc = x.contiguous()
    su, sd = _scalar(s_up, dev), _scalar(s_down, dev)
    bu, bd = _vec(b_up, dev), _vec(b_down, dev)
    wu, wd = _words(w_up, dev), _words(w_down, dev)
    out = torch.empty((m, kout), dtype=x.dtype, device=dev)
    if m == 0:
        return out
    ws = torch.empty((h // HIDDEN_TILE, m, kout), dtype=torch.float32, device=dev)
    _cuda_call("fused_mlp", xc, xc.data_ptr(), int(x.dtype == torch.bfloat16),
               wu.data_ptr(), su.data_ptr(), bu.data_ptr(), wd.data_ptr(),
               sd.data_ptr(), bd.data_ptr(), ws.data_ptr(), out.data_ptr(),
               m, k, h, kout, float(alpha), int(compute_dtype == torch.bfloat16))
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
) -> torch.Tensor:
    """The transformer block's tail in one call::

        resid = x + s_wo·(att @ Wo) + b_wo
        h     = rmsnorm(resid, norm2, eps)
        up    = prelu(s_up·(h @ Wup) + b_up, alpha)
        out   = resid + s_down·(up @ Wdown) + b_down

    att: (M, A) pre-``wo`` attention mix; x: (M, D) residual stream, read
    in f32. A row's result is bitwise independent of the other rows in the
    call (M = 1 against M = C: the speculative-decoding contract). Returns
    (M, D) in x.dtype.
    """
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
    attc, xc = att.contiguous(), x.contiguous()
    if attc.device != dev:
        raise ValueError("att must be on x's device")
    swo, su, sd = _scalar(s_wo, dev), _scalar(s_up, dev), _scalar(s_down, dev)
    bwo, g2 = _vec(b_wo, dev), _vec(norm2, dev)
    bu, bd = _vec(b_up, dev), _vec(b_down, dev)
    wod, wu, wd = _words(wo, dev), _words(w_up, dev), _words(w_down, dev)
    out = torch.empty((m, dm), dtype=x.dtype, device=dev)
    if m == 0:
        return out
    resid = torch.empty((m, dm), dtype=torch.float32, device=dev)
    ws = torch.empty((h // HIDDEN_TILE, m, dm), dtype=torch.float32, device=dev)
    ptrs = [t.data_ptr() for t in (wod, swo, bwo, g2, wu, su, bu, wd, sd, bd,
                                   resid, ws, out)]
    _cuda_call("fused_block_tail", xc, attc.data_ptr(), int(att.dtype == torch.bfloat16),
               xc.data_ptr(), int(x.dtype == torch.bfloat16), *ptrs, m, a, dm, h,
               float(alpha), float(eps), int(compute_dtype == torch.bfloat16))
    fused_block_tail.launches += 1
    return out


fused_block_tail.launches = 0
