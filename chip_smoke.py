#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (smmb_tpu_torch) on one CUDA card and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, each of
which exits non-zero on failure:

1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build every CUDA kernel of the path from the sources in the checkout;
3. each kernel against its plain PyTorch version on the card, in every
   mode, at the test shapes and the headline shapes, with and without bias
   and PReLU, and the launch counter rising once per call;
4. the main path at full width: the packed ternary MLP of
   ``python -m smmb_tpu_torch mlp`` (depth 4, dim 4096, batch 256, density
   1/10, bf16) with exactly one kernel launch per layer, and the MLP of
   ``__graft_entry__.entry()`` ((1024, 2048, 2048, 1024), batch 64, f32),
   each against the plain path;
5. times through ``bench/measure.py`` (CUDA events): per mode at the
   headline shape the kernel, its bound, the plain version and one PyTorch
   library call on the same inputs; the full-width MLP forward;
6. the fused LM kernels (B3 fused_norm_qkv, B5 fused_block_tail, B6
   fused_mlp) against their plain versions in f32 and bf16 compute at the
   shapes of the LM path (and B3 at a GQA width, N = 1536), each call
   raising its launch count by one;
7. row identity: row 0 of an M = 8 call equals the M = 1 call bitwise
   (B3, B5, B6);
8. the LM main path: ``generate`` at the default configuration of
   ``python -m smmb_tpu_torch lm`` (4 layers, d_model 1024, 8 heads, d_ff
   4096, vocab 8192, batch 1, 32-token prompt, 64 greedy steps, bf16) with
   the launch counts of every kernel, its per-step logits (bf16 and f32)
   held against the plain path (the kernels' plain versions in their place)
   teacher-forced on its tokens, and µs/token from ``bench/lm_bench.py``;
9. times of B3, B5 and B6 at the path's shapes: kernel, plain version,
   bound, and ``torch.matmul`` on the pre-decoded dense bf16 weights.

The line before the last is the card's name and power limit, the line
before that the per-kernel JSON summary, and the last line
``{"ok": true, "device": {...}}``. Without a CUDA card it exits 1 and
prints no result.
"""

import contextlib
import json
import subprocess
import sys
import time

T0 = time.time()
ALPHA = 0.2


def log(msg: str) -> None:
    print(f"[{time.time() - T0:7.1f}s] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        print(f"FAIL: {msg}", flush=True)
        sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def main() -> int:
    import torch

    check(torch.cuda.is_available(), "no CUDA device: the port runs on the card")
    from smmb_tpu_torch.bench.flops import sparse_flops, spmm_bytes
    from smmb_tpu_torch.bench.measure import measure
    from smmb_tpu_torch.bench.mlp_bench import build_mlp, run_mlp_bench
    from smmb_tpu_torch.bench.roofline import chip_spec, roofline_bound
    from smmb_tpu_torch.formats.packed import pack_ternary_device, unpack_ternary
    from smmb_tpu_torch.kernels import _build
    from smmb_tpu_torch.kernels.packed_spmm import (
        packed_spmm,
        packed_spmm_plain,
        quantize_rows,
    )
    from smmb_tpu_torch.models.mlp import (
        TernaryMLPConfig,
        init_mlp,
        mlp_forward,
        pack_mlp,
    )
    from smmb_tpu_torch.utils import rng

    # ---------------------------------------------------------------- 1
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    spec = chip_spec()
    log(f"roofline spec: {spec}")
    dev = torch.device("cuda")

    # ---------------------------------------------------------------- 2
    t = time.time()
    build_logs = _build.build_all()
    log(f"built {sorted(build_logs) or 'nothing (up to date)'} "
        f"in {time.time() - t:.1f}s")
    for src, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "Function properties" in line or "spill" in line:
                print(f"    {src}: {line.strip()}")

    # ---------------------------------------------------------------- 3
    # tolerances, each relative to max(1, max|Y|):
    #  f32  1e-4: f32 sums in another order than the cuBLAS f32 product;
    #  bf16 2**-7: X and Y in bf16; the f32 sums agree to ~1e-6, so
    #       rounding Y to bf16 differs by at most one bf16 ulp (2**-7 rel);
    #  int8 1e-6: same int8 codes and exact integer sums on both sides and
    #       the same separately rounded dequant and bias (f32 output).
    modes = {  # name: (compute dtype, x dtype, tolerance)
        "f32": (torch.float32, torch.float32, 1e-4),
        "bf16": (torch.bfloat16, torch.bfloat16, 2.0 ** -7),
        "int8": (torch.int8, torch.float32, 1e-6),
    }
    # the test shapes, the headline shapes and the entry() MLP's layers
    shapes = [(1, 512, 1024), (16, 512, 512), (8, 1024, 640), (100, 512, 512),
              (4, 100, 256), (8, 2048, 256), (1, 4096, 4096), (256, 4096, 4096),
              (64, 1024, 2048), (64, 2048, 2048), (64, 2048, 1024)]
    gen = rng.make_generator(1234, dev)
    n_checked = 0
    for (m, k, n) in shapes:
        non_zero = 10 if k == 4096 else 2
        w = rng.rand_ternary(gen, (k, n), non_zero=non_zero)
        p = pack_ternary_device(w)
        check(torch.equal(unpack_ternary(p), w), f"pack round trip {k}x{n}")
        b = rng.rand_dense(gen, (n,))
        for name, (cdt, xdt, tol) in modes.items():
            x = rng.rand_dense(gen, (m, k), dtype=xdt)
            for bias, alpha in ((b, ALPHA), (None, None)):
                before = packed_spmm.launches
                y = packed_spmm(x, p, bias, alpha, compute_dtype=cdt)
                check(packed_spmm.launches == before + 1,
                      f"launch count {name} {m}x{k}x{n}")
                ref = packed_spmm_plain(x, p, bias, alpha, compute_dtype=cdt)
                torch.cuda.synchronize()
                check(y.shape == (m, n) and y.dtype == xdt, f"shape/dtype {name}")
                check(bool(torch.isfinite(y).all()), f"non-finite {name} {m}x{k}x{n}")
                err = float((y.float() - ref.float()).abs().max())
                lim = tol * max(1.0, float(ref.float().abs().max()))
                check(err <= lim, f"kernel vs plain {name} {m}x{k}x{n} "
                      f"bias={bias is not None}: err {err:.3e} > {lim:.3e}")
                n_checked += 1
        log(f"kernel == plain at {m}x{k}x{n} in f32, bf16, int8")
    x3 = rng.rand_dense(gen, (3, 4, 512))
    p3 = pack_ternary_device(rng.rand_ternary(gen, (512, 256)))
    y3 = packed_spmm(x3, p3, None, ALPHA)
    ref3 = packed_spmm_plain(x3.reshape(12, 512), p3, None, ALPHA).reshape(3, 4, 256)
    check(y3.shape == (3, 4, 256), "3-D x keeps its leading dims")
    check(float((y3 - ref3).abs().max()) <= 1e-4 * max(1.0, float(ref3.abs().max())),
          "3-D x kernel vs plain")
    log(f"phase 3 passed: {n_checked + 1} kernel calls checked against plain")

    # ---------------------------------------------------------------- 4
    cfg, packed, x, _ = build_mlp(4, 4096, 256, 10, dev)
    torch.cuda.synchronize()
    packed_spmm.launches = 0
    y = mlp_forward(packed, x, cfg, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    main_launches = packed_spmm.launches
    check(main_launches == cfg.num_layers,
          f"main path launched packed_spmm {main_launches} times, "
          f"expected {cfg.num_layers}")
    y_ref = mlp_forward(packed, x, cfg, compute_dtype=torch.bfloat16, use_kernel=False)
    torch.cuda.synchronize()
    check(y.shape == (256, 4096) and bool(torch.isfinite(y).all()),
          "full-width MLP output shape / finiteness")
    # each layer re-rounds its input to bf16; sums that differ in order by
    # ~1e-6 can flip that rounding by one bf16 ulp (2**-8 relative)
    err = float((y - y_ref).abs().max())
    scale = float(y_ref.abs().max())
    check(err <= 1e-2 * scale, f"full-width MLP kernel vs plain: {err:.3e} "
          f"vs max|Y| {scale:.3e}")
    log(f"main path (depth 4 x 4096, batch 256, bf16): launches {main_launches}, "
        f"max err {err:.3e} of max|Y| {scale:.3e}")

    ecfg = TernaryMLPConfig(layer_dims=(1024, 2048, 2048, 1024))
    egen = rng.make_generator(1, dev)
    epacked = pack_mlp(init_mlp(egen, ecfg))
    ex = rng.rand_dense(egen, (64, 1024))
    torch.cuda.synchronize()
    packed_spmm.launches = 0
    ey = mlp_forward(epacked, ex, ecfg)
    torch.cuda.synchronize()
    entry_launches = packed_spmm.launches
    check(entry_launches == ecfg.num_layers, f"entry MLP launches {entry_launches}")
    ey_ref = mlp_forward(epacked, ex, ecfg, use_kernel=False)
    torch.cuda.synchronize()
    eerr = float((ey - ey_ref).abs().max())
    escale = float(ey_ref.abs().max())
    check(ey.shape == (64, 1024) and bool(torch.isfinite(ey).all()), "entry MLP shape")
    check(eerr <= 1e-5 * max(1.0, escale), f"entry MLP f32 kernel vs plain: "
          f"{eerr:.3e} vs max|Y| {escale:.3e}")
    log(f"entry() MLP (1024,2048,2048,1024), batch 64, f32: launches "
        f"{entry_launches}, max err {eerr:.3e} of max|Y| {escale:.3e}")

    # ---------------------------------------------------------------- 5
    m, k, n = 256, 4096, 4096
    hgen = rng.make_generator(0, dev)
    hx = rng.rand_dense(hgen, (m, k))
    hw = rng.rand_ternary(hgen, (k, n), non_zero=10)
    hb = rng.rand_dense(hgen, (n,))
    nnz = int(torch.count_nonzero(hw))
    hp = pack_ternary_device(hw, nnz=nnz)
    n_bytes = spmm_bytes(m, n, k, weight_bytes=hp.weight_bytes())
    torch.backends.cuda.matmul.allow_tf32 = False
    hw_dense = unpack_ternary(hp)
    library = {
        "f32": (torch.matmul, (hx, hw_dense)),
        "bf16": (torch.matmul, (hx.to(torch.bfloat16), hw_dense.to(torch.bfloat16))),
        "int8": (torch._int_mm, (quantize_rows(hx)[0], hw_dense.to(torch.int8))),
    }
    per_mode = {}
    for name, (cdt, _, tol) in modes.items():
        y = packed_spmm(hx, hp, hb, ALPHA, compute_dtype=cdt)
        ref = packed_spmm_plain(hx, hp, hb, ALPHA, compute_dtype=cdt)
        torch.cuda.synchronize()
        max_err = float((y - ref).abs().max())
        t_kernel = measure(lambda: packed_spmm(hx, hp, hb, ALPHA, compute_dtype=cdt))
        t_plain = measure(lambda: packed_spmm_plain(hx, hp, hb, ALPHA, compute_dtype=cdt))
        lib_fn, lib_args = library[name]
        t_lib = measure(lib_fn, *lib_args)
        bound_s, bound_by = roofline_bound(sparse_flops(m, n, nnz), n_bytes, spec, name)
        dense_s, dense_by = roofline_bound(2.0 * m * n * k, n_bytes, spec, name)
        per_mode[name] = {
            "mode": name, "shape": [m, k, n], "nnz": nnz, "max_abs_err": max_err,
            "ms": t_kernel.min_s * 1e3, "mean_ms": t_kernel.mean_s * 1e3,
            "std_ms": t_kernel.std_s * 1e3, "plain_ms": t_plain.min_s * 1e3,
            "library_ms": t_lib.min_s * 1e3, "bound_ms": bound_s * 1e3,
            "bound_by": bound_by, "dense_bound_ms": dense_s * 1e3,
            "dense_bound_by": dense_by,
        }
        print(json.dumps(per_mode[name]), flush=True)

    x1 = rng.rand_dense(hgen, (1, k))
    t1 = measure(lambda: packed_spmm(x1, hp, hb, ALPHA, compute_dtype=torch.bfloat16))
    t1_plain = measure(
        lambda: packed_spmm_plain(x1, hp, hb, ALPHA, compute_dtype=torch.bfloat16))
    b1, b1_by = roofline_bound(sparse_flops(1, n, nnz),
                               spmm_bytes(1, n, k, weight_bytes=hp.weight_bytes()),
                               spec, "bf16")
    print(json.dumps({"mode": "bf16", "shape": [1, k, n], "ms": t1.min_s * 1e3,
                      "plain_ms": t1_plain.min_s * 1e3, "bound_ms": b1 * 1e3,
                      "bound_by": b1_by}), flush=True)

    for use_kernel in (True, False):
        r = run_mlp_bench(4, 4096, 256, 10, use_kernel=use_kernel, device=dev)
        print(json.dumps({
            "mlp": r.label, "depth": 4, "dim": 4096, "batch": 256,
            "compute": "bf16", "ms": r.min_s * 1e3, "mean_ms": r.mean_s * 1e3,
            "rows_per_s": r.rows_per_s, "nnz_per_s": r.nnz_per_s,
            "bound_ms": r.bound_s * 1e3, "bound_by": r.bound_by,
            "frac_roofline": r.frac_roofline,
        }), flush=True)

    fused = check_fused_kernels(torch, dev)
    lm = run_lm_path(torch, dev)
    fused_rows = time_fused_kernels(torch, dev, spec, fused, lm)

    main_mode = per_mode["bf16"]  # the main path's mode and per-layer shape
    summary = {"kernels": [{
        "name": "packed_spmm",
        "route": "cuda",
        "source": "smmb_tpu_torch/kernels/csrc/packed_spmm.cu",
        "replaces": "smmb_tpu/kernels/packed_spmm.py:388",
        "launches": main_launches,
        "max_abs_err": main_mode["max_abs_err"],
        "ms": main_mode["ms"],
        "plain_ms": main_mode["plain_ms"],
        "bound_ms": main_mode["bound_ms"],
        "bound_by": main_mode["bound_by"],
        "library_ms": main_mode["library_ms"],
    }, *fused_rows]}
    log(f"all phases passed in {time.time() - T0:.1f}s")
    print(json.dumps(summary), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


# ------------------------------------------------------------ LM slice
def _tern(gen, shape):
    from smmb_tpu_torch.formats.packed import pack_ternary_device
    from smmb_tpu_torch.utils import rng

    return pack_ternary_device(rng.rand_ternary(gen, shape, non_zero=2))


def _fused_inputs(torch, gen, name, m, d, n_or_h, dev, x_dtype=None):
    """Random inputs of one fused kernel at d (K, A, D) and n_or_h (N or H)."""
    from smmb_tpu_torch.utils import rng

    f32 = torch.float32
    sc = lambda v: torch.tensor(v, dtype=f32, device=dev)  # noqa: E731
    xd = x_dtype or f32
    if name == "fused_norm_qkv":
        n = n_or_h
        return (rng.rand_dense(gen, (m, d), dtype=xd),
                1.0 + 0.1 * rng.rand_dense(gen, (d,)), _tern(gen, (d, n)),
                0.5 + rng.rand_dense(gen, (n,)).abs(), rng.rand_dense(gen, (n,)))
    h = n_or_h
    if name == "fused_mlp":
        return (rng.rand_dense(gen, (m, d), dtype=xd), _tern(gen, (d, h)),
                sc(0.37), rng.rand_dense(gen, (h,)), _tern(gen, (h, d)),
                sc(1.21), rng.rand_dense(gen, (d,)))
    return (rng.rand_dense(gen, (m, d), dtype=x_dtype or torch.bfloat16),
            rng.rand_dense(gen, (m, d)), _tern(gen, (d, d)), sc(0.9),
            rng.rand_dense(gen, (d,)), 1.0 + 0.1 * rng.rand_dense(gen, (d,)),
            _tern(gen, (d, h)), sc(0.37), rng.rand_dense(gen, (h,)),
            _tern(gen, (h, d)), sc(1.21), rng.rand_dense(gen, (d,)))


def _fused_kwargs(name, cdt):
    if name == "fused_norm_qkv":
        return dict(eps=1e-6, compute_dtype=cdt)
    if name == "fused_mlp":
        return dict(alpha=ALPHA, compute_dtype=cdt)
    return dict(alpha=ALPHA, eps=1e-6, compute_dtype=cdt)


def _rows(args, name, r0, r1):
    """The inputs restricted to rows [r0, r1) (activations only)."""
    n_act = 2 if name == "fused_block_tail" else 1
    return tuple(a[r0:r1] if i < n_act else a for i, a in enumerate(args))


# the LM path's shapes: B3 at M=1 (and the GQA width), B5 at M=1, B6 at M=32
FUSED_SHAPES = [
    ("fused_norm_qkv", 1, 1024, 3072), ("fused_norm_qkv", 1, 1024, 1536),
    ("fused_norm_qkv", 8, 1024, 3072), ("fused_block_tail", 1, 1024, 4096),
    ("fused_block_tail", 8, 1024, 4096), ("fused_mlp", 32, 1024, 4096),
    ("fused_mlp", 1, 1024, 4096), ("fused_mlp", 3, 512, 1024),
]


def check_fused_kernels(torch, dev) -> dict:
    """Phases 6 and 7. Returns {name: max abs err at the path shape, bf16}."""
    from smmb_tpu_torch.kernels import fused_mlp as fk
    from smmb_tpu_torch.utils import rng

    # tolerances, relative to max(1, max|Y|): f32 1e-4 (f32 sums in another
    # order than the plain version's exact product); bf16 2**-7 (a sum that
    # differs by an f32 ulp can round a staged value to the next bf16)
    tol = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}
    gen = rng.make_generator(77, dev)
    path_err = {}
    for name, m, d, n_or_h in FUSED_SHAPES:
        fn, plain = getattr(fk, name), getattr(fk, name + "_plain")
        args = _fused_inputs(torch, gen, name, m, d, n_or_h, dev)
        for cdt in (torch.float32, torch.bfloat16):
            kw = _fused_kwargs(name, cdt)
            before = fn.launches
            y = fn(*args, **kw)
            check(fn.launches == before + 1, f"{name} launch count")
            ref = plain(*args, **kw)
            torch.cuda.synchronize()
            check(y.shape == ref.shape and y.dtype == ref.dtype, f"{name} shape/dtype")
            check(bool(torch.isfinite(y).all()), f"{name} non-finite {m}x{d}x{n_or_h}")
            err = float((y.float() - ref.float()).abs().max())
            lim = tol[cdt] * max(1.0, float(ref.float().abs().max()))
            check(err <= lim, f"{name} kernel vs plain {cdt} {m}x{d}x{n_or_h}: "
                  f"err {err:.3e} > {lim:.3e}")
            if cdt == torch.bfloat16 and (m, d, n_or_h) == _path_shape(name):
                path_err[name] = err
        log(f"{name} == plain at M={m}, {d}x{n_or_h} in f32 and bf16")
    # bf16 x in, bf16 out
    args = _fused_inputs(torch, gen, "fused_mlp", 4, 1024, 2048, dev, torch.bfloat16)
    y = fk.fused_mlp(*args, **_fused_kwargs("fused_mlp", torch.bfloat16))
    ref = fk.fused_mlp_plain(*args, **_fused_kwargs("fused_mlp", torch.bfloat16))
    torch.cuda.synchronize()
    check(y.dtype == torch.bfloat16, "bf16 x gives a bf16 result")
    check(float((y.float() - ref.float()).abs().max())
          <= 2.0 ** -7 * max(1.0, float(ref.float().abs().max())), "bf16 in/out fused_mlp")
    log("phase 6 passed: B3, B5, B6 agree with their plain versions")

    for name in ("fused_norm_qkv", "fused_block_tail", "fused_mlp"):
        _, _, d, n_or_h = next(s for s in FUSED_SHAPES if s[0] == name)
        fn = getattr(fk, name)
        args = _fused_inputs(torch, gen, name, 8, d, n_or_h, dev)
        for cdt in (torch.float32, torch.bfloat16):
            kw = _fused_kwargs(name, cdt)
            chunk = fn(*args, **kw)
            row = fn(*_rows(args, name, 0, 1), **kw)
            torch.cuda.synchronize()
            check(torch.equal(chunk[:1], row), f"{name} row 0 of M=8 != M=1 ({cdt})")
    log("phase 7 passed: row 0 of an M=8 call equals the M=1 call bitwise")
    return path_err


def _path_shape(name):
    return {"fused_norm_qkv": (1, 1024, 3072), "fused_block_tail": (1, 1024, 4096),
            "fused_mlp": (32, 1024, 4096)}[name]


def run_lm_path(torch, dev) -> dict:
    """Phase 8: ``generate`` at the default ``lm`` configuration."""
    from smmb_tpu_torch.bench.lm_bench import build_lm, run_lm_bench
    from smmb_tpu_torch.kernels import fused_mlp as fk
    from smmb_tpu_torch.kernels.packed_spmm import packed_spmm
    from smmb_tpu_torch.models.lm import TernaryLMConfig, generate

    layers, prompt_len, steps = 4, 32, 64
    cfg = TernaryLMConfig(vocab=8192, d_model=1024, n_heads=8, d_ff=4096,
                          n_layers=layers, max_len=prompt_len + 3 * steps)
    packed, prompt = build_lm(cfg, 1, prompt_len, device=dev)
    bf16 = torch.bfloat16
    counted = (packed_spmm, fk.fused_norm_qkv, fk.fused_block_tail, fk.fused_mlp)
    torch.cuda.synchronize()
    for fn in counted:
        fn.launches = 0
    toks = generate(packed, prompt, cfg, steps, compute_dtype=bf16)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counted}
    log(f"generate: launches {launches}")
    check(toks.shape == (1, steps) and int(toks.min()) >= 0
          and int(toks.max()) < cfg.vocab, "generate tokens shape / range")
    check(launches["fused_mlp"] == layers, "B6 launches once per layer in the prefill")
    check(launches["fused_norm_qkv"] == layers * steps, "B3 once per layer per step")
    check(launches["fused_block_tail"] == layers * steps, "B5 once per layer per step")
    # B1: 6 projections per layer in the prefill (k, v for the cache, then
    # q, k, v, o of the forward, as in JAX) + the head once in the prefill
    # and once per step
    b1 = 6 * layers + 1 + steps
    check(launches["packed_spmm"] == b1, f"B1 launches {launches['packed_spmm']} != {b1}")

    # per-step logits, teacher-forced on the kernel path's tokens, against
    # the plain path: the same entry points on the card with each kernel's
    # plain version in its place. This random model's attention scores are
    # in the hundreds, so one ulp of a staged value can move a step's logits
    # by more than one rounding would; the unfused path through plain
    # products (use_kernel=False) measures that spread, and the kernel path
    # may be no farther from the plain path than that spread or the
    # tolerance, with its median step within the tolerance.
    for cdt, tol in ((bf16, 2.0 ** -7), (torch.float32, 1e-4)):
        ids = toks if cdt == bf16 else generate(packed, prompt, cfg, steps,
                                                compute_dtype=cdt)
        kern = _teacher_forced(torch, cfg, packed, prompt, ids, cdt, True)
        with plain_kernels():
            plain = _teacher_forced(torch, cfg, packed, prompt, ids, cdt, True)
        unfused = _teacher_forced(torch, cfg, packed, prompt, ids, cdt, False)
        check(bool(torch.isfinite(kern).all()), "LM logits finite")
        check(torch.equal(kern.argmax(-1), ids[0]),
              "teacher-forced kernel path reproduces generate's tokens")
        scale = plain.abs().amax(-1).clamp_min(1.0)
        err = (kern - plain).abs().amax(-1) / scale
        spread = (unfused - plain).abs().amax(-1) / scale
        med, worst = float(err.median()), float(err.max())
        check(med <= tol, f"LM {cdt}: median step error {med:.3e} > {tol:.3e}")
        check(worst <= max(tol, float(spread.max())),
              f"LM {cdt}: worst step error {worst:.3e} beyond the tolerance "
              f"{tol:.3e} and the plain orders' spread {float(spread.max()):.3e}")
        top2 = torch.topk(plain, 2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]) / scale
        differs = plain.argmax(-1) != ids[0]
        check(not bool((differs & (gap > tol)).any()),
              f"LM {cdt}: a token differs where the plain top-2 gap exceeds {tol:.1e}")
        log(f"LM {cdt} logits vs plain over {steps} steps: median {med:.2e}, worst "
            f"{worst:.2e} (plain orders' spread {float(spread.max()):.2e}, tolerance "
            f"{tol:.1e}); {int(differs.sum())} near-tied tokens differ")
    r = run_lm_bench(cfg, 1, prompt_len, steps, reps=3, device=dev)
    rp = _plain_lm_tokens_time(torch, cfg, packed, prompt, steps)
    print(json.dumps({"lm": "generate", "layers": layers, "d_model": 1024,
                      "d_ff": 4096, "vocab": 8192, "prompt": prompt_len,
                      "steps": steps, "us_per_token": r.per_token_s * 1e6,
                      "tok_per_s": r.tokens_per_s, "lo_ms": r.lo_s * 1e3,
                      "hi_ms": r.hi_s * 1e3, "plain_us_per_token": rp * 1e6,
                      "launches": launches}), flush=True)
    log(f"phase 8 passed: {r.per_token_s * 1e6:.1f} us/token, "
        f"{r.tokens_per_s:.0f} tok/s (plain path {rp * 1e6:.1f} us/token)")
    return {"launches": launches}


def _teacher_forced(torch, cfg, packed, prompt, ids, cdt, use_kernel):
    """(steps, vocab) f32 logits of lm_prefill then lm_decode_step on ``ids``."""
    from smmb_tpu_torch.models.lm import lm_decode_step, lm_init_cache, lm_prefill

    kw = dict(compute_dtype=cdt, use_kernel=use_kernel)
    cache = lm_init_cache(cfg, prompt.shape[0], dtype=cdt, device=prompt.device)
    logits, cache = lm_prefill(packed, prompt, cache, cfg, **kw)
    out = [logits]
    for i in range(ids.shape[1] - 1):
        logits, cache = lm_decode_step(packed, ids[:, i], cache, cfg, **kw)
        out.append(logits)
    torch.cuda.synchronize()
    return torch.stack(out, 1)[0].float()


@contextlib.contextmanager
def plain_kernels():
    """The LM path's four kernels replaced by their plain versions, for the
    reference run of phase 8 (the wrappers themselves launch on any CUDA
    tensor); the launch counts do not move."""
    from smmb_tpu_torch.kernels import fused_mlp as fk
    from smmb_tpu_torch.kernels.packed_spmm import packed_spmm_plain
    from smmb_tpu_torch.models import attention, lm, transformer

    def plain_of(fn):
        return lambda *a, block_h=None, block_n=None, **k: fn(*a, **k)

    swaps = [(fk, n, plain_of(getattr(fk, n + "_plain")))
             for n in ("fused_norm_qkv", "fused_block_tail", "fused_mlp")]
    swaps += [(m, "packed_spmm", packed_spmm_plain) for m in (attention, transformer, lm)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _plain_lm_tokens_time(torch, cfg, packed, prompt, steps) -> float:
    """µs/token slope of ``generate(use_kernel=False)`` on the card (the
    unfused path through the plain PyTorch products), as lm_bench times the
    kernel path."""
    from smmb_tpu_torch.bench.measure import measure
    from smmb_tpu_torch.models.lm import generate

    def timed(n):
        return measure(lambda: generate(packed, prompt, cfg, n,
                                        compute_dtype=torch.bfloat16,
                                        use_kernel=False), reps=3).min_s

    return (timed(3 * steps) - timed(steps)) / (2 * steps)


def time_fused_kernels(torch, dev, spec, path_err, lm) -> list:
    """Phase 9: each fused kernel at the path's shape, bf16 compute."""
    from smmb_tpu_torch.bench.measure import measure
    from smmb_tpu_torch.bench.roofline import roofline_bound
    from smmb_tpu_torch.formats.packed import unpack_ternary
    from smmb_tpu_torch.kernels import fused_mlp as fk
    from smmb_tpu_torch.utils import rng

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = rng.make_generator(5, dev)
    sources = {"fused_norm_qkv": ":332", "fused_block_tail": ":707", "fused_mlp": ":195"}
    per_launch = {"fused_norm_qkv": "per decode step (4 layers)",
                  "fused_block_tail": "per decode step (4 layers)",
                  "fused_mlp": "per 32-token prefill (4 layers)"}
    rows = []
    for name in ("fused_norm_qkv", "fused_block_tail", "fused_mlp"):
        m, d, n_or_h = _path_shape(name)
        args = _fused_inputs(torch, gen, name, m, d, n_or_h, dev)
        kw = _fused_kwargs(name, torch.bfloat16)
        fn, plain = getattr(fk, name), getattr(fk, name + "_plain")
        t_kernel = measure(lambda: fn(*args, **kw))
        t_plain = measure(lambda: plain(*args, **kw))
        planes = [a for a in args if hasattr(a, "weight_bytes")]
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        out = fn(*args, **kw)
        n_bytes = (sum(p.weight_bytes() for p in planes)
                   + sum(t.numel() * t.element_size() for t in tensors)
                   + out.numel() * out.element_size())
        nnz = [int(torch.count_nonzero(unpack_ternary(p))) for p in planes]
        ops = 2.0 * m * sum(nnz)  # the ±1 entries this data holds, per row
        bound_s, bound_by = roofline_bound(ops, n_bytes, spec, "bf16")
        # library yardstick: torch.matmul on the pre-decoded dense bf16
        # weights, one call per product of the kernel, times summed
        dense = [unpack_ternary(p, torch.bfloat16) for p in planes]
        t_lib = 0.0
        for w in dense:
            a = rng.rand_dense(gen, (m, w.shape[0]), dtype=torch.bfloat16)
            t_lib += measure(torch.matmul, a, w).min_s
        row = {
            "name": name, "route": "cuda",
            "source": "smmb_tpu_torch/kernels/csrc/fused_mlp.cu",
            "replaces": "smmb_tpu/kernels/fused_mlp.py" + sources[name],
            "launches": lm["launches"][name], "max_abs_err": path_err[name],
            "ms": t_kernel.min_s * 1e3, "plain_ms": t_plain.min_s * 1e3,
            "bound_ms": bound_s * 1e3, "bound_by": bound_by,
            "library_ms": t_lib * 1e3,
        }
        print(json.dumps({**row, "shape": [m, d, n_or_h], "bytes": n_bytes,
                          "ops": ops, "mean_ms": t_kernel.mean_s * 1e3,
                          "launches_are": per_launch[name],
                          "library": f"torch.matmul bf16 on pre-decoded dense W, "
                                     f"sum of {len(dense)} products"}), flush=True)
        rows.append(row)
    log("phase 9 passed: fused kernels timed at the path shapes")
    return rows


if __name__ == "__main__":
    sys.exit(main())
