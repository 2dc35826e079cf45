"""The span sweep of the flash decode kernels B4 and B8: the device time of
one decode step's cache read under spans of several widths, each output held
against the plain version walking the same spans.

``kernels/flash_decode.py::split_cols(S)`` picks the span the kernel uses;
this sweep shows what the neighbouring choices cost on the card. One row per
(S, kernel, span): B = 1, H = KVH = 8, hd 128, bf16 (B4 over a bf16 cache,
B8 over the int8 cache), q at pos S - 1, device time by the profiler
(bench/trace.py's kernel breakdown), and SDPA's device time on the same live
prefix (B8: on the dequantized bf16 cache).

CLI: python -m smmb_tpu_torch.bench.decode_spans [--seq 1024,8192,32768]
"""

from __future__ import annotations

import argparse
import json

import torch

from smmb_tpu_torch.bench.trace import kernel_breakdown
from smmb_tpu_torch.kernels import flash_decode as fd
from smmb_tpu_torch.models import attention
from smmb_tpu_torch.utils import rng

HEADS, HD = 8, 128


def _device_us(fn) -> float:
    return sum(r["us"] for r in kernel_breakdown(fn, n_calls=30))


def sweep(s_len: int, device: torch.device, seed: int = 0) -> list[dict]:
    """Rows of the sweep at pos S - 1 of an S-column cache: spans of half,
    one, two and four times ``split_cols(S)`` (at most 64 spans)."""
    import torch.nn.functional as F

    bf16 = torch.bfloat16
    gen = rng.make_generator(seed, device)
    pos = s_len - 1
    q = rng.rand_dense(gen, (1, HEADS, HD)) * 8.0
    kc = rng.rand_dense(gen, (1, s_len, HEADS * HD), dtype=bf16)
    vc = rng.rand_dense(gen, (1, s_len, HEADS * HD), dtype=bf16)
    cfg = attention.TernaryAttentionConfig(d_model=HEADS * HD, n_heads=HEADS)
    cache = attention._cache_write(
        attention.init_kv_cache(cfg, 1, s_len, quantized=True, device=device),
        rng.rand_dense(gen, (1, s_len, HEADS, HD)), rng.rand_dense(gen, (1, s_len, HEADS, HD)), 0)
    kv, sc = cache["kv"], cache["kv_scale"]
    kd, vd = (t.to(bf16).transpose(1, 2).contiguous() for t in attention._cache_kv(cache, HEADS))
    scale = HD ** -0.5
    base = fd.split_cols(s_len)
    spans = [sp for sp in (base // 2, base, 2 * base, 4 * base)
             if sp >= fd.KV_TILE and sp % fd.KV_TILE == 0 and -(-s_len // sp) <= 64]
    q4 = q[:, None]
    rows = []
    for name, bufs, lib_kv in (("B4", (kc, vc, None), (
            kc.view(1, s_len, HEADS, HD).transpose(1, 2), vc.view(1, s_len, HEADS, HD).transpose(1, 2))),
            ("B8", (kv, None, sc), (kd, vd))):
        library_us = _device_us(lambda: F.scaled_dot_product_attention(
            q.to(bf16)[:, :, None], *lib_kv))
        for span in spans:
            def call():
                return fd._launch(q4, *bufs, pos, None, scale, bf16, HEADS, span)

            y = call()
            ref = fd._cache_attention_plain(q4, bufs[0], bufs[1], pos, None, None, None, bf16,
                                            bufs[2], split_cols=span)
            torch.cuda.synchronize()
            err = float((y.float() - ref.float()).abs().max())
            lim = 2.0 ** -7 * max(1.0, float(ref.float().abs().max()))
            if err > lim:
                raise AssertionError(f"{name} S={s_len} span {span}: err {err:.3e} > {lim:.3e}")
            rows.append({"device": torch.cuda.get_device_name(device), "kernel": name,
                         "S": s_len, "pos": pos, "span": span, "split_cols": span == base,
                         "blocks": fd.live_spans(pos, 1, None, span)[1] * HEADS,
                         "device_us": _device_us(call), "max_abs_err": err,
                         "sdpa_device_us": library_us})
            print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seq", default="1024,8192,32768", help="cache lengths S")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the span sweep times the CUDA kernels: it needs a card")
    for s_len in (int(x) for x in args.seq.split(",")):
        sweep(s_len, torch.device("cuda"))


if __name__ == "__main__":
    main()
