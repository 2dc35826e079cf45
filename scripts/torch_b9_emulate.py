"""B9's and B9p's CUDA-core body run on the CPU, bitwise against an earlier
tree's: each source's ``csrc/flash_attention.cu`` is rewritten for
``scripts/cuda_emu.h`` (one OS thread per CUDA thread), built with g++ and
called on the same inputs, every row tile of this checkout against the
earlier body at its kv tile. No card and no nvcc needed; exp2f is the
host's, so this holds orders and indexing, not the card's bits.

    python scripts/torch_b9_emulate.py PARENT_DIR [--quick]

Prints one JSON line a case and exits 1 if any output differs.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from smmb_tpu_torch.kernels.flash_attention import core_rows, kernel_tile  # noqa: E402

# (dtype 0 f32 / 1 bf16, B, H, KVH, T, S, hd, causal, window, pad): pad
# widens k's and v's token stride (element staging)
CASES = [
    (0, 1, 2, 2, 150, 150, 32, True, None, 0), (0, 1, 4, 1, 150, 150, 32, True, 40, 0),
    (0, 2, 3, 1, 70, 70, 20, True, None, 0), (0, 1, 2, 2, 100, 130, 24, False, None, 0),
    (1, 1, 2, 2, 100, 100, 48, True, 30, 0), (0, 1, 2, 1, 90, 90, 30, True, 20, 0),
    (0, 1, 2, 2, 90, 90, 32, True, None, 1), (0, 1, 2, 2, 160, 60, 16, True, 10, 0),
    (0, 1, 2, 2, 60, 160, 16, True, 25, 0), (1, 1, 2, 2, 70, 70, 96, True, None, 0),
    (0, 1, 2, 2, 140, 140, 128, True, None, 0), (0, 1, 2, 2, 80, 80, 200, True, 50, 0),
    (0, 1, 2, 2, 70, 70, 209, True, None, 0), (1, 1, 2, 2, 70, 70, 256, True, None, 0),
    (0, 1, 2, 2, 50, 50, 300, False, None, 0), (0, 1, 2, 2, 40, 40, 444, True, None, 0),
    (1, 1, 2, 1, 40, 40, 512, True, 20, 0), (0, 1, 1, 1, 36, 36, 898, True, None, 0),
    (0, 1, 1, 1, 36, 36, 902, True, None, 0),
]

HARNESS = r"""
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#define ENTRY(name) extern "C" int name(const void*, const long long*, const void*, \
  const long long*, const void*, const long long*, void*, const long long*, int, int, int, \
  int, int, int, int, int, int, float, int, int, ROWS_ARG void*)
ENTRY(smmb_flash_attention);
ENTRY(smmb_flash_attention_pipe);
static unsigned long long st = 88172645463325252ull;
static float rnd() {
  st ^= st << 13; st ^= st >> 7; st ^= st << 17;
  return float(((st >> 11) * (1.0 / 9007199254740992.0) - 0.5) * 4.0);
}
static unsigned short bf(float f) {
  unsigned u; memcpy(&u, &f, 4); u += 0x7fffu + ((u >> 16) & 1u); return u >> 16;
}
int main(int argc, char** argv) {
  int a[13];
  for (int i = 0; i < 13; ++i) a[i] = atoi(argv[i + 1]);
  const int dt = a[0], b = a[1], h = a[2], kvh = a[3], t = a[4], s = a[5], hd = a[6];
  const int causal = a[7], window = a[8], pipe = a[9], bt = a[10], rows = a[11], pad = a[12];
  (void)rows;
  const size_t es = dt ? 2 : 4, ld = hd + pad;
  long long qs[3] = {(long long)h * t * hd, (long long)t * hd, hd};
  long long ks[3] = {(long long)(kvh * s * ld), (long long)(s * ld), (long long)ld};
  const size_t nq = (size_t)b * h * t * hd, nk = (size_t)b * kvh * s * ld;
  std::vector<unsigned char> q(nq * es), k(nk * es), v(nk * es), o(nq * es);
  auto fill = [&](std::vector<unsigned char>& x, size_t n, float sc) {
    for (size_t i = 0; i < n; ++i) {
      float f = rnd() * sc;
      if (dt) { unsigned short w = bf(f); memcpy(&x[i * 2], &w, 2); }
      else memcpy(&x[i * 4], &f, 4);
    }
  };
  fill(q, nq, 4.f); fill(k, nk, 1.f); fill(v, nk, 1.f);
  float qscale = (float)(1.0 / sqrt((double)hd) * 1.4426950408889634);
  if (dt) { unsigned u = unsigned(bf(qscale)) << 16; memcpy(&qscale, &u, 4); }
  auto fn = pipe ? smmb_flash_attention_pipe : smmb_flash_attention;
  int rc = fn(q.data(), qs, k.data(), ks, v.data(), ks, o.data(), qs, dt, b, t, s, h, kvh, hd,
              causal, window, qscale, 0, bt, ROWS_VAL nullptr);
  if (rc) { fprintf(stderr, "rc %d\n", rc); return 3; }
  fwrite(o.data(), 1, nq * es, stdout);
  return 0;
}
"""


def emulated(source: Path, work: Path, name: str, rows_arg: bool) -> Path:
    """``source`` rewritten for cuda_emu.h and built with the harness main()."""
    s = source.read_text()
    s = s.replace("#include <cuda_bf16.h>\n", "").replace(
        "#include <cuda_runtime.h>\n", f'#include "{ROOT / "scripts" / "cuda_emu.h"}"\n')
    s = s.replace('#include "mma_sm90.cuh"\n', "")
    s = re.sub(r"extern __shared__ (?:__align__\(16\) )?([\w ]+?) (\w+)\[\];",
               r"SMEM_PTR(\1, \2);", s)
    s = re.sub(r"(\w+)<<<([^,]+),\s*([^,]+),\s*([^,]+),\s*([^>]+)>>>\((.*?)\);",
               lambda m: f"emu_launch({m[2]}, {m[3]}, {m[4]}, [&]{{ {m[1]}({m[6]}); }});",
               s, flags=re.S)
    src, drv, exe = work / f"{name}.cpp", work / f"{name}_main.cpp", work / name
    src.write_text(s)
    drv.write_text(HARNESS.replace("ROWS_ARG", "int," if rows_arg else "")
                   .replace("ROWS_VAL", "rows," if rows_arg else ""))
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-pthread", "-w",
                    str(src), str(drv), "-o", str(exe)], check=True, timeout=1800)
    return exe


def run(exe, case, pipe, rows):
    dt, b, h, kvh, t, s, hd, causal, window, pad = case
    args = [dt, b, h, kvh, t, s, hd, int(causal), window or 0, int(pipe),
            kernel_tile(hd, pipe), rows, pad]
    r = subprocess.run([str(exe), *map(str, args)], capture_output=True, timeout=1800)
    if r.returncode:
        raise RuntimeError(f"{exe.name} {case} pipe={pipe}: {r.stderr.decode()[-500:]}")
    return r.stdout


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path, help="an earlier tree of the port")
    ap.add_argument("--quick", action="store_true", help="the first four cases only")
    args = ap.parse_args(argv)
    rel = Path("smmb_tpu_torch/kernels/csrc/flash_attention.cu")
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        this = emulated(ROOT / rel, work, "this", True)
        parent = emulated(args.parent / rel, work, "parent", False)
        ok = True
        for case in CASES[:4] if args.quick else CASES:
            dt, hd, causal = case[0], case[6], case[7]
            for pipe in (False, True) if causal and hd <= 898 else (False,):
                want = run(parent, case, pipe, 0)
                rows = core_rows((torch.float32, torch.bfloat16)[dt], hd, pipe)
                same = {r: run(this, case, pipe, r) == want for r in rows}
                ok &= all(same.values())
                print(json.dumps({"case": case, "pipeline_p": pipe, "bitwise_by_rows": same}),
                      flush=True)
    print(json.dumps({"all_bitwise": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
