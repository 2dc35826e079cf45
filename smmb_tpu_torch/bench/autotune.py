"""Offline tile autotuner for B1, the packed SpMM kernel (counterpart of
smmb_tpu/bench/autotune.py).

B1 has four output tiles in each mode, BM 16|64 by BN 64|128
(kernels/packed_spmm.py::MMA_TILES for bf16 and int8, ``F32_TILES`` for
f32), and bf16 a fifth, the wide body's 128×256 (``tiles_of``); every tile
of a mode gives the same output bitwise; ``tile_for``
picks one by a rule of M and N. This utility times each candidate for one (M, K, N, dtype) on the card with
``bench/measure.py::measure_device`` and caches the fastest in a JSON file,
so that a deployment can pin it:

    from smmb_tpu_torch.bench.autotune import autotune_packed_spmm
    cfg = autotune_packed_spmm(256, 4096, 4096)   # {'block_m': .., 'block_n': ..}
    y = packed_spmm(x, w, b, compute_dtype=torch.bfloat16, **cfg)

JAX's TPU tiles and its ``decode: "fold"`` candidates have no
counterpart: the kernel has one decode. A candidate that the wrapper
refuses is skipped, as JAX skips a config that fails to compile. On ``device="cpu"`` each candidate runs the
plain version, timed by the host's clock (``measure_host``): that exercises
the selection and the cache, not the card.

The cache is ``$SMMB_TORCH_AUTOTUNE_CACHE``, else
``~/.smmb_tpu_torch_autotune.json`` (not JAX's file: the keys and the
tiles differ), keyed ``"<device name>|MxKxN|<dtype>"``.

CLI: python -m smmb_tpu_torch.bench.autotune M K N [--dtype bf16|f32|int8]
"""

from __future__ import annotations

import json
import os

import torch

from smmb_tpu_torch.bench.measure import HOST_CALLS, measure_device, measure_host
from smmb_tpu_torch.formats.packed import pack_ternary_device
from smmb_tpu_torch.kernels.packed_spmm import packed_spmm, tiles_of
from smmb_tpu_torch.utils import rng
from smmb_tpu_torch.utils.device import resolve_device

CACHE_PATH = os.environ.get(
    "SMMB_TORCH_AUTOTUNE_CACHE", os.path.expanduser("~/.smmb_tpu_torch_autotune.json")
)
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32, "int8": torch.int8}


def default_candidates(m: int, dtype) -> list:
    """The kernel's tiles for ``dtype`` (every M takes the same ones: the
    tile changes the grid, not the sums; bf16 has its wide tile too)."""
    return [{"block_m": bm, "block_n": bn} for bm, bn in tiles_of(dtype)]


def _key(m, k, n, dtype, device) -> str:
    dev = "cpu" if device.type == "cpu" else torch.cuda.get_device_name(device)
    return f"{dev.replace(' ', '_')}|{m}x{k}x{n}|{str(dtype).split('.')[-1]}"


def _load_cache() -> dict:
    try:
        with open(CACHE_PATH) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def autotune_packed_spmm(
    m: int,
    k: int,
    n: int,
    dtype=torch.bfloat16,
    *,
    candidates=None,
    non_zero: int = 10,
    reps: int = 3,
    use_cache: bool = True,
    verbose: bool = False,
    device=None,
) -> dict:
    """Time the candidate tiles at (m, k, n) in ``dtype``'s mode, return
    the fastest (keyword arguments of ``packed_spmm``) and cache it.
    ``device`` None is the card; without one this raises."""
    dev = resolve_device(device)
    key = _key(m, k, n, dtype, dev)
    cache = _load_cache()
    if use_cache and key in cache:
        return cache[key]["config"]

    gen = rng.make_generator(0, dev)
    x = rng.rand_dense(gen, (m, k), dtype=torch.bfloat16 if dtype == torch.bfloat16
                       else torch.float32)
    p = pack_ternary_device(rng.rand_ternary(gen, (k, n), non_zero=non_zero))
    best, best_t = None, float("inf")
    for cand in candidates or default_candidates(m, dtype):

        def f(x, cand=cand):
            return packed_spmm(x, p, compute_dtype=dtype, **cand)

        try:
            if dev.type == "cuda":
                meas = measure_device(f, x, reps=reps)
            else:
                meas = measure_host(f, x, calls=HOST_CALLS, reps=reps)
        except ValueError as e:  # a tile the kernel does not have
            if verbose:
                print(f"  {json.dumps(cand)}: refused ({e})")
            continue
        if verbose:
            print(f"  {json.dumps(cand)}: {meas.min_s * 1e6:.3f} us", flush=True)
        if meas.min_s < best_t:
            best, best_t = cand, meas.min_s

    if best is None:
        raise RuntimeError("no candidate tile ran")
    cache[key] = {"config": best, "time_us": best_t * 1e6}
    try:
        with open(CACHE_PATH, "w") as f:
            json.dump(cache, f, indent=2)
    except OSError:
        pass
    return best


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("m", type=int)
    ap.add_argument("k", type=int)
    ap.add_argument("n", type=int)
    ap.add_argument("--dtype", default="bf16", choices=sorted(DTYPES))
    args = ap.parse_args(argv)
    cfg = autotune_packed_spmm(args.m, args.k, args.n, DTYPES[args.dtype],
                               use_cache=False, verbose=True)
    print(json.dumps(cfg))


if __name__ == "__main__":
    main()
