"""Tiny copies of the cells that ``perfbench_tiny_cells.py`` does not know:
the routed LM's prefill (``mellum2.code-prefill``) and the dense LM's small
decode batch (``lm2b.decode-b8``), written into the same tiny data root.

``register()`` (called by this directory's ``conftest.py``, before any test
module imports ``perfbench_tiny_cells``) adds their names to its ``CELLS``
and wraps its ``write_root``, so every harness test that walks the tiny
cells takes these two as well.
"""

from __future__ import annotations

import json
from pathlib import Path

import perfbench_tiny_cells as tiny

NEW = {"mellum2.code-prefill": "tiny.routed", "lm2b.decode-b8": "tiny.decode-b8"}
LIMITS = {"tiny.routed": {"first_token_gap": 0.02, "logit_row_err": 0.025},
          "tiny.decode-b8": {"token_gap": 0.02, "logit_row_err": 0.02}}


def tiny_routed_config() -> dict:
    """The routed LM's configuration at a CPU test's size: one period of the
    3:1 sliding/full pattern, a window of 8, head width 32 apart from d 64,
    16 experts top-4."""
    cfg = json.loads((tiny.PKG / "configs" / "mellum2-12b-a2.5b.json").read_text())
    cfg.update(vocab_size=512, hidden_size=64, num_hidden_layers=4, num_attention_heads=4,
               num_key_value_heads=2, head_dim=32, num_experts=16, num_experts_per_tok=4,
               moe_intermediate_size=32, sliding_window=8, max_len=64,
               router_gain=8.0, layer_types=cfg["layer_types"][:4])
    return cfg


def _write(root: Path, name: str, full: str, config: str, params: dict, check: dict,
           limits: dict) -> dict:
    w = json.loads((tiny.PKG / "workloads" / f"{full}.json").read_text())
    w["config"] = config
    w["params"].update(params)
    w["check"].update(check)
    w["check"]["limits"] = limits
    w["trace"] = {"warm_units": 1, "units": 2}
    (root / "workloads" / f"{name}.json").write_text(json.dumps(w))
    return {"name": name, "config": config, "traffic": w["traffic"], "chips": 1, "why": "tiny"}


def register() -> None:
    for full, name in NEW.items():
        tiny.CELLS.setdefault(full, name)
    if getattr(tiny.write_root, "routed", False):
        return
    write_root = tiny.write_root

    def write_all(root: Path, limits: dict | None = None) -> Path:
        path = write_root(root, limits)
        lim = {**LIMITS, **(limits or {})}
        (root / "configs" / "tiny-routed.json").write_text(json.dumps(tiny_routed_config()))
        manifest = json.loads(path.read_text())
        manifest["configs"].append({"name": "tiny-routed", "source": "tiny",
                                    "file": "configs/tiny-routed.json", "reduced": [],
                                    "why": "tiny"})
        manifest["workloads"] += [
            _write(root, "tiny.routed", "mellum2.code-prefill", "tiny-routed",
                   {"lengths": [8, 16, 32], "cache_len": 64}, {}, lim["tiny.routed"]),
            _write(root, "tiny.decode-b8", "lm2b.decode-b8", "tiny-lm",
                   {"batch": 4, "prompt_len": 16, "decode_steps": 8, "cache_len": 32,
                    "warm_steps": 1}, {"rows": 4, "steps": 3, "sequences": 4},
                   lim["tiny.decode-b8"]),
        ]
        path.write_text(json.dumps(manifest))
        return path

    write_all.routed = True
    tiny.write_root = write_all
