"""Multi-rank scaling harness (counterpart of smmb_tpu/bench/scaling.py).

Measures the sharded products' nnz/s at a series of mesh sizes and reports
the scaling efficiency ``rate(N) / (N · rate(1))`` for each partitioning:

* ``column`` — output-column sharding, no forward collective
  (parallel/sharded.py: sharded_spmm_column)
* ``row`` — K-row sharding with a model-axis all_reduce
  (parallel/sharded.py: sharded_spmm_row)
* ``overlap`` — column sharding fed by the ring-overlapped activation
  all-gather (parallel/overlap.py)
* ``bcsr_column`` — block-column-sharded BCSR, 30% stored 128×128 blocks
  (parallel/bcsr_sharded.py)
* ``tp_block`` — one tensor-parallel transformer block at 4096-d, 8 heads,
  4096-ff, its rate over the six packed projections
  (parallel/tp_transformer.py)
* ``pp_lm`` — the pipeline-parallel LM forward, layers = max(4, stages),
  its rate over every block weight (parallel/pp_lm.py)
* ``ep_moe`` — expert-parallel MoE: the next slice of the port (raises).

Each mesh size is one ``run_world`` that runs every asked partitioning;
each rank times its calls and the slowest rank's mean is the point's time.
On the card the times are ``bench/measure.py``'s ``measure`` (CUDA events,
a fixed number of calls a batch, so that every rank issues the same
collectives); on CPU tensors ``measure_host`` (host wall clock). A world of
more ranks than cards puts several ranks on one card: such points are
marked ``shared``, since they measure ranks taking turns on one device, not
scaling across devices. The backend follows from ranks against cards: gloo
when ranks share a card or run on the CPU (NCCL refuses two ranks on one
device), NCCL otherwise.
"""

from __future__ import annotations

import dataclasses
import json

import torch

from smmb_tpu_torch.utils.device import resolve_device

PARTITIONINGS = ("column", "row", "overlap", "bcsr_column", "tp_block", "pp_lm", "ep_moe")
SCALING_CALLS = 10  # calls a timed batch when ``iters`` is not given


@dataclasses.dataclass(frozen=True)
class ScalePoint:
    partitioning: str
    devices: int  # ranks
    mesh: str
    mean_s: float
    nnz_per_s: float
    efficiency: float  # vs linear scaling from the first point
    shared: bool  # ranks shared cards (or the host): not scaling across devices
    timer: str  # "device" (CUDA events) or "host" (wall clock)
    backend: str


def _workloads(parts, m, k, n, non_zero, max_model, dev) -> dict:
    """The global inputs of each partitioning, made from fixed seeds on
    ``dev`` (the same on every rank)."""
    from smmb_tpu_torch.formats.packed import pack_ternary_device
    from smmb_tpu_torch.utils import rng

    out = {}
    gen = rng.make_generator(0, dev)
    x = rng.rand_dense(gen, (m, k))
    w = rng.rand_ternary(gen, (k, n), non_zero=non_zero)
    b = rng.rand_dense(gen, (n,))
    if {"column", "row", "overlap"} & set(parts):
        out["packed"] = (x, pack_ternary_device(w), b, int(torch.count_nonzero(w)) * m)
    if "bcsr_column" in parts:
        from smmb_tpu_torch.formats.bcsr import bcsr_from_dense
        from smmb_tpu_torch.kernels.bcsr_spmm import bcsr_prepare

        bgen = rng.make_generator(7, dev)
        mask = (torch.rand((k // 128, n // 128), generator=bgen, device=dev) < 0.3).float()
        wb = w * mask.repeat_interleave(128, 0).repeat_interleave(128, 1)
        prep = bcsr_prepare(bcsr_from_dense(wb, 128, 128, device=dev), device=dev)
        out["bcsr_column"] = (x, prep, b, int(torch.count_nonzero(wb)) * m)
    if "tp_block" in parts:
        from smmb_tpu_torch.models.transformer import TernaryBlockConfig, init_block, pack_block

        # d_model 4096 keeps the row-sharded out-projection 512-group
        # aligned up to model = 8; tokens = m (batch 2 × m/2)
        bcfg = TernaryBlockConfig(d_model=4096, n_heads=8, d_ff=4096)
        params = init_block(rng.make_generator(4, dev), bcfg)
        nnz = sum(int(torch.count_nonzero(params["attn"][nm])) for nm in ("wq", "wk", "wv", "wo"))
        nnz += int(torch.count_nonzero(params["w_up"])) + int(torch.count_nonzero(params["w_down"]))
        xb = rng.rand_dense(rng.make_generator(5, dev), (2, m // 2, bcfg.d_model)) * 0.1
        out["tp_block"] = (bcfg, pack_block(params), xb, nnz * m)
    if "pp_lm" in parts:
        from smmb_tpu_torch.models.lm import TernaryLMConfig, init_lm, pack_lm

        lcfg = TernaryLMConfig(vocab=2048, d_model=1024, n_heads=8, d_ff=4096,
                               n_layers=max(4, max_model), max_len=64)
        lparams = init_lm(rng.make_generator(4, dev), lcfg)
        nnz = sum(int(torch.count_nonzero(blk["attn"][nm])) for blk in lparams["blocks"]
                  for nm in ("wq", "wk", "wv", "wo"))
        nnz += sum(int(torch.count_nonzero(blk[nm])) for blk in lparams["blocks"]
                   for nm in ("w_up", "w_down"))
        toks = torch.randint(0, lcfg.vocab, (8, 32), generator=rng.make_generator(5, dev),
                             device=dev)
        out["pp_lm"] = (lcfg, pack_lm(lparams), toks, nnz * toks.numel())
    return out


def _case(part, wl, mesh, use_kernel):
    """(fn, args, work) of one partitioning on ``mesh``, or None where the
    shapes do not shard over it (JAX's skips)."""
    from smmb_tpu_torch.parallel import bcsr_sharded, overlap, pp_lm, sharded, tp_transformer
    from smmb_tpu_torch.parallel.mesh import local_cols, local_rows

    data, model = mesh.data, mesh.model
    kw = dict(mesh=mesh, use_kernel=use_kernel)
    if part in ("column", "row", "overlap"):
        x, p, b, work = wl["packed"]
        if x.shape[0] % data:
            return None
        xl = local_rows(x, mesh)
        if part == "row":
            ws = sharded.shard_packed_rows(p, mesh)
            return sharded.sharded_spmm_row, (local_cols(xl, mesh), ws, b), kw, work
        if part == "overlap" and p.rows % (model * 512):
            return None
        ws = sharded.shard_packed_columns(p, mesh)
        if part == "overlap":
            return (overlap.sharded_spmm_column_overlapped, (local_cols(xl, mesh), ws, b), kw,
                    work)
        return sharded.sharded_spmm_column, (xl, ws, b), kw, work
    if part == "bcsr_column":
        x, prep, b, work = wl["bcsr_column"]
        if x.shape[0] % data:
            return None
        shards = bcsr_sharded.shard_bcsr_columns(prep, mesh)
        return bcsr_sharded.sharded_bcsr_spmm, (local_rows(x, mesh), shards, b), \
            {"mesh": mesh}, work
    if part == "tp_block":
        bcfg, bpacked, xb, work = wl["tp_block"]
        if (bcfg.n_heads % model or bcfg.d_model % (512 * model)
                or bcfg.d_ff % (512 * model) or xb.shape[0] % data):
            return None
        return (tp_transformer.block_forward_tp,
                (tp_transformer.shard_block_tp(bpacked, mesh), local_rows(xb, mesh), bcfg),
                kw, work)
    if part == "pp_lm":
        lcfg, lpacked, toks, work = wl["pp_lm"]
        if lcfg.n_layers % model or toks.shape[0] % (2 * data):
            return None
        return (pp_lm.lm_forward_pp, (pp_lm.shard_lm_pp(lpacked, mesh), local_rows(toks, mesh),
                                      lcfg), {**kw, "microbatches": 2}, work)
    raise ValueError(part)


def _scaling_rank(world, parts, m, k, n, non_zero, shape, max_model, calls, reps,
                  use_kernel) -> list:
    """One mesh size's world: every partitioning's slowest-rank mean time."""
    from smmb_tpu_torch.bench.measure import measure, measure_host
    from smmb_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, all_reduce, make_mesh

    dev = world.device
    mesh = make_mesh(*shape, device=dev)
    wl = _workloads(parts, m, k, n, non_zero, max_model, dev)
    out = []
    for part in parts:
        case = _case(part, wl, mesh, use_kernel)
        if case is None:
            out.append((part, None, None))
            continue
        fn, args, kw, work = case

        def call(fn=fn, args=args, kw=kw):
            return fn(*args, **kw)

        if dev.type == "cuda":
            t = measure(call, calls=calls, reps=reps).mean_s
        else:
            t = measure_host(call, calls=calls, reps=reps).mean_s
        slowest = torch.tensor([t], dtype=torch.float64, device=dev)
        for axis in (MODEL_AXIS, DATA_AXIS):
            slowest = all_reduce(slowest, mesh, axis, op="max")
        out.append((part, float(slowest[0]), work))
    return out


def run_scaling(m: int = 256, k: int = 4096, n: int = 4096, non_zero: int = 10,
                mesh_shapes=((1, 1), (1, 2), (1, 4), (1, 8)), *,
                partitioning: str = "column", partitionings=None, iters: int | None = None,
                reps: int = 3, use_kernel: bool = True, device=None) -> list[ScalePoint]:
    """Sharded products over growing meshes, the weights fixed: each model
    rank owns its slice of the weight planes, so per-rank work shrinks with
    the mesh and perfect scaling keeps the time flat. ``partitionings`` (a
    tuple) runs several in each world; ``partitioning`` names one.
    ``iters``: calls a timed batch (``SCALING_CALLS`` when None)."""
    parts = tuple(partitionings) if partitionings is not None else (partitioning,)
    for part in parts:
        if part not in PARTITIONINGS:
            raise ValueError(f"partitioning must be one of {PARTITIONINGS}")
        if part == "ep_moe":
            from smmb_tpu_torch.parallel.mesh import MOE_SLICE

            raise NotImplementedError(MOE_SLICE)
    from smmb_tpu_torch.parallel.mesh import run_world

    dev = resolve_device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    max_model = max(mm for _, mm in mesh_shapes)
    calls = iters if iters is not None else SCALING_CALLS
    points: list[ScalePoint] = []
    base: dict = {}
    for data, model in mesh_shapes:
        ranks = data * model
        shared = dev.type == "cpu" or ranks > cards
        bk = "gloo" if shared else "nccl"
        res = run_world(_scaling_rank, ranks, backend=bk, device=dev.type,
                        args=(parts, m, k, n, non_zero, (data, model), max_model, calls,
                              reps, use_kernel))[0]
        for part, mean_s, work in res:
            if mean_s is None:
                continue
            rate = work / mean_s
            if part not in base:
                base[part] = (rate, ranks)
            eff = rate / (base[part][0] * ranks / base[part][1])
            points.append(ScalePoint(part, ranks, f"{data}x{model}", mean_s, rate, eff, shared,
                                     "device" if dev.type == "cuda" else "host", bk))
    return points


def main(argv=None) -> int:
    import argparse

    from smmb_tpu_torch.utils.config import BenchConfig

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default=None,
                    help="BenchConfig JSON file (mesh_shapes, iters, reps)")
    ap.add_argument("--partitionings", default="column,row,overlap,bcsr_column,tp_block,pp_lm",
                    help=f"comma-separated subset of {','.join(PARTITIONINGS)}")
    ap.add_argument("--mesh", default=None,
                    help="comma-separated data x model shapes, e.g. 1x1,1x2")
    ap.add_argument("--reps", type=int, default=None)
    args = ap.parse_args(argv)

    cfg = BenchConfig()
    if args.config:
        with open(args.config) as f:
            cfg = BenchConfig.from_json(f.read())
    shapes = cfg.mesh_shapes
    if args.mesh:
        shapes = tuple(tuple(int(v) for v in s.split("x")) for s in args.mesh.split(","))
    reps = args.reps if args.reps is not None else cfg.reps
    pts = run_scaling(mesh_shapes=shapes, partitionings=args.partitionings.split(","),
                      iters=cfg.iters, reps=reps)
    cards = max(torch.cuda.device_count(), 1)
    for pt in pts:
        where = (f"{pt.devices} ranks sharing {cards} card(s)" if pt.shared
                 else f"{pt.devices} ranks on {pt.devices} cards")
        print(f"[{pt.partitioning:11s}] mesh={pt.mesh} {where} ({pt.backend})  "
              f"t={pt.mean_s * 1e6:9.1f}us  nnz/s={pt.nnz_per_s:.3e}  "
              f"eff={pt.efficiency * 100:5.1f}%", flush=True)
        print(json.dumps(dataclasses.asdict(pt)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
