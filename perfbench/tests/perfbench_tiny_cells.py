"""Tiny copies of the benchmark's cells for the harness's CPU tests: the same
traffic kinds, systems, references and check numbers as ``BENCHMARK.json``'s
cells, at sizes a CPU test holds, in a data root of their own."""

from __future__ import annotations

import json
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
REPO = PKG.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

CELLS = {"mlp4096.b256": "tiny.mlp", "lm2b.prefill-mix": "tiny.prefill",
         "lm2b.decode-b64": "tiny.decode"}


def _load(sub: str, name: str) -> dict:
    return json.loads((PKG / sub / f"{name}.json").read_text())


def write_root(root: Path, limits: dict | None = None) -> Path:
    """Write tiny configs, workloads and a manifest under ``root``; returns
    the manifest's path. ``limits`` overrides a tiny cell's check limits."""
    (root / "configs").mkdir(parents=True, exist_ok=True)
    (root / "workloads").mkdir(exist_ok=True)
    lm = _load("configs", "ternary-lm-2b")
    lm.update(vocab=512, d_model=256, n_layers=2, n_heads=2, n_kv_heads=1, d_ff=512,
              max_len=64)
    mlp = _load("configs", "mlp4096")
    mlp.update(layer_dims=[256, 256, 256])
    cfgs = {"tiny-lm": lm, "tiny-mlp": mlp}
    for name, cfg in cfgs.items():
        (root / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    tiny = {
        "tiny.mlp": ("mlp4096.b256", "tiny-mlp",
                     {"rows": 8, "pool": 4, "warm_calls": 2, "check_every": 4, "keep_rounds": 2},
                     {}, {"y_row_err": 0.008}),
        "tiny.prefill": ("lm2b.prefill-mix", "tiny-lm",
                         {"lengths": [8, 16, 32], "cache_len": 64}, {},
                         {"first_token_gap": 0.02, "logit_row_err": 0.02}),
        "tiny.decode": ("lm2b.decode-b64", "tiny-lm",
                        {"batch": 4, "prompt_len": 16, "decode_steps": 8, "cache_len": 32,
                         "warm_steps": 1}, {"rows": 3, "steps": 3, "sequences": 6},
                        {"token_gap": 0.02, "logit_row_err": 0.02}),
    }
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    manifest["configs"] = [{"name": n, "source": "tiny", "file": f"configs/{n}.json",
                            "reduced": [], "why": "tiny"} for n in cfgs]
    manifest["workloads"] = []
    for name, (full, cfg, params, check, lim) in tiny.items():
        w = _load("workloads", full)
        w["config"] = cfg
        w["params"].update(params)
        w["check"].update(check)
        w["check"]["limits"] = (limits or {}).get(name, lim)
        w["trace"] = {"warm_units": 1, "units": 2}
        (root / "workloads" / f"{name}.json").write_text(json.dumps(w))
        manifest["workloads"].append({"name": name, "config": cfg, "traffic": full,
                                      "chips": 1, "why": "tiny"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [CELLS[c] for c in m["workloads"]]
    path = root / "BENCHMARK.json"
    path.write_text(json.dumps(manifest))
    return path
