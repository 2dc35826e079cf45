"""How often the Mellum cell's program and its f32 reference route a token
to different experts: a diagnostic beside the cell's check, not part of it.

    python3 scripts/torch_mellum_route_flips.py --seeds 1101 2203 3305

For each seed: the cell's system (``perfbench/systems/ternary_moe_lm.py``)
prefills one request of each of the cell's lengths (its prompts drawn as
the window draws them) with ``moe.grouped_layout`` wrapped to keep each
layer's top-k experts; then, the program freed, the reference
(``perfbench/reference/ternary_moe_lm.py``) runs the same prompts with its
``routed`` wrapped to keep its own. A (token, layer) differs when its two
sets of experts differ. The program routes on its bf16 normalised stream
through f32 logits summed in f64; the reference on its f32 stream. Each
seed prints one JSON line: the (token, layer) pairs compared and how many
differ, in all and per length; the last line sums the seeds.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

CELL = "mellum2.code-prefill"


def one_seed(seed: int, cell, dev) -> dict:
    import torch

    from perfbench.lib import spec
    from perfbench.reference import ternary_moe_lm as reference
    from smmb_tpu_torch.models import moe

    p = cell.params
    system = spec.system_module(cell.config).System(cell.config, seed, dev, p["cache_len"])
    layers = system.lm.n_layers
    groups, program = [], []
    layout = moe.grouped_layout

    def keep(expert, slot, n):
        program.append(expert.sort(dim=-1).values)
        return layout(expert, slot, n)

    moe.grouped_layout = keep
    try:
        for j, length in enumerate(p["lengths"]):
            tokens = system.prompts("prefill", j, p["batch"], length)
            system.prefill(tokens, system.new_cache(p["batch"]),
                           getattr(torch, p["compute_dtype"]), p["use_flash"])
            groups.append({"tokens": tokens, "positions": [length - 1]})
    finally:
        moe.grouped_layout = layout
    system.free()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = []
    routed = reference.routed

    def keep_ref(h, m, up, down, dm, r):
        gates = torch.softmax(h @ m["router"], dim=-1)
        top = torch.sort(gates, dim=-1, descending=True, stable=True).indices[:, :dm["top_k"]]
        ref.append(top.sort(dim=-1).values)
        return routed(h, m, up, down, dm, r)

    reference.routed = keep_ref
    try:
        reference.logits(cell.config, seed, groups, dev)
    finally:
        reference.routed = routed
    n_groups = len(groups)
    out = {"seed": seed, "pairs": 0, "differ": 0, "by_length": {}}
    for g, length in enumerate(p["lengths"]):
        pairs = differ = 0
        for layer in range(layers):
            a = program[g * layers + layer]
            b = ref[layer * n_groups + g]  # the reference walks layers, then groups
            pairs += a.shape[0]
            differ += int((a != b).any(dim=-1).sum())
        out["by_length"][length] = {"pairs": pairs, "differ": differ}
        out["pairs"] += pairs
        out["differ"] += differ
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    from perfbench.lib import env

    env.prepare(REPO / "perfbench")
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    from perfbench.lib import spec
    from smmb_tpu_torch.kernels import _build

    _build.build_all()
    cell = spec.load_cell(CELL)
    rows = []
    for seed in args.seeds:
        rows.append(one_seed(seed, cell, torch.device("cuda")))
        print(json.dumps(rows[-1]), flush=True)
    pairs, differ = sum(r["pairs"] for r in rows), sum(r["differ"] for r in rows)
    print(json.dumps({"seeds": args.seeds, "pairs": pairs, "differ": differ,
                      "share": differ / pairs}), flush=True)


if __name__ == "__main__":
    main()
