#!/usr/bin/env python
"""Example: mesh-sharded serving of a packed ternary MLP on the PyTorch port
(the counterpart of examples/sharded_serving.py).

One process a rank over ``torch.distributed`` (``run_world``): the
Megatron-paired sharded MLP (column → row + all_reduce → column) against
the single-rank forward, then a column layer fed by feature-sharded
activations through the ring-overlapped all-gather. On the card by default
(NCCL when every rank has its own card, else gloo with the ranks sharing
them); on CPU ranks over gloo with ``--cpu``:

    python examples/torch_sharded_serving.py --cpu
    python examples/torch_sharded_serving.py --ranks 2
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402

from smmb_tpu_torch.models.mlp import (  # noqa: E402
    TernaryMLPConfig,
    init_mlp,
    mlp_forward,
    mlp_forward_sharded,
    pack_mlp,
    shard_mlp,
)
from smmb_tpu_torch.parallel import (  # noqa: E402
    make_mesh,
    run_world,
    sharded_spmm_column,
    sharded_spmm_column_overlapped,
)
from smmb_tpu_torch.parallel import mesh as pm  # noqa: E402
from smmb_tpu_torch.parallel.sharded import shard_packed_columns  # noqa: E402
from smmb_tpu_torch.utils import rng  # noqa: E402


def _rank(world, data, dims, rows):
    """One rank: its rows of the sharded MLP and of the overlapped column
    layer, each against the unsharded call; the worst errors over the mesh."""
    dev = world.device
    mesh = make_mesh(data, world.size // data, device=dev)
    cfg = TernaryMLPConfig(layer_dims=dims)
    packed = pack_mlp(init_mlp(rng.make_generator(0, dev), cfg))
    x = rng.rand_dense(rng.make_generator(1, dev), (rows * data, dims[0]))
    xl = pm.local_rows(x, mesh)

    # Megatron-paired sharded forward against the single-rank forward
    y = mlp_forward_sharded(shard_mlp(packed, mesh), xl, cfg, mesh=mesh)
    ref = mlp_forward(packed, xl, cfg)
    mlp_err = float((y - ref).abs().max()) / max(1.0, float(ref.abs().max()))

    # ring-overlapped column layer on a feature-sharded input, against the
    # column layer that takes the whole input
    w0 = shard_packed_columns(packed["w"][0], mesh)
    y0 = sharded_spmm_column_overlapped(pm.local_cols(xl, mesh), w0, packed["b"][0], mesh=mesh,
                                        alpha=cfg.alpha)
    ref0 = sharded_spmm_column(xl, w0, packed["b"][0], mesh=mesh, alpha=cfg.alpha)
    ring_err = float((y0 - ref0).abs().max()) / max(1.0, float(ref0.abs().max()))

    worst = torch.tensor([mlp_err, ring_err], dtype=torch.float64, device=dev)
    for axis in (pm.MODEL_AXIS, pm.DATA_AXIS):
        worst = pm.all_reduce(worst, mesh, axis, op="max")
    return {"mesh": dict(mesh.shape), "out": tuple(y.shape), "panel": tuple(y0.shape),
            "mlp_err": float(worst[0]), "ring_err": float(worst[1])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cpu", action="store_true", help="CPU ranks over gloo")
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks (default: 4 on the CPU, 2 or the cards on the card)")
    ap.add_argument("--data", type=int, default=None,
                    help="data-axis size (default: 2 when it divides the ranks)")
    ap.add_argument("--dims", default="2048,4096,2048,2048", help="the MLP's layer widths")
    ap.add_argument("--rows", type=int, default=16, help="batch rows a data shard")
    args = ap.parse_args(argv)

    cards = 0 if args.cpu else torch.cuda.device_count()
    if not args.cpu and not cards:
        raise SystemExit("no CUDA device: pass --cpu to run on CPU ranks")
    ranks = args.ranks or (4 if args.cpu else max(2, cards))
    data = args.data or (2 if ranks % 2 == 0 and ranks > 2 else 1)
    backend = "gloo" if args.cpu or ranks > cards else "nccl"
    dims = tuple(int(d) for d in args.dims.split(","))
    res = run_world(_rank, ranks, backend=backend, device="cpu" if args.cpu else "cuda",
                    args=(data, dims, args.rows))[0]
    where = "CPU ranks" if args.cpu else (
        f"{ranks} ranks on {cards} card(s)" + (", sharing them" if ranks > cards else ""))
    print(f"mesh {res['mesh']} over {where} ({backend})")
    print(f"sharded MLP == single rank: worst error {res['mlp_err']:.2e} of max(1, max|Y|); "
          f"a rank's output {res['out']}")
    print(f"overlapped column layer == the column layer: worst error {res['ring_err']:.2e}; "
          f"a rank's panel {res['panel']}")
    ok = res["mlp_err"] <= 1e-4 and res["ring_err"] <= 1e-4
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
