"""One process of a multi-process run of the port's parallel layer.

Each process calls ``smmb_tpu_torch.parallel.multihost.initialize_multihost``
with the coordinator's TCP address, the process count and its index, so
the processes form one world, as they would across hosts. Then, on meshes
over that world, it checks the column-sharded SpMM, the row-sharded SpMM
(its all_reduce crosses processes), the ring-overlapped column SpMM (every
ring hop crosses processes), one tensor-parallel block (processes 0 and 1)
and, with 4 processes, a 4-stage pipeline-parallel LM forward against the
port's single-process results on the same inputs, within TOL_DENSE
(max(TOL_DENSE, 2e-5·max|ref|) for the block and the LM). It prints
``PASS_<stage>`` for each check it passed, ``MULTIHOST_OK process <i>``
at the end, and ``PRIMARY_OK`` on the one primary process, which also
writes the gathered results to ``--out`` as .npy files.

    python scripts/torch_multihost_worker.py --process-id 0 --num-processes 2 \
        --coordinator localhost:12345 --backend gloo --device cpu --out DIR

The inputs are numpy arrays from fixed seeds (``inputs``), so that a caller
can build the same ones.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BLOCK = dict(d_model=1024, n_heads=4, d_ff=1024)
LM = dict(vocab=256, d_model=512, n_heads=4, d_ff=512, n_layers=4, max_len=16)


def _tern(rs, shape, non_zero=2):
    p = 1.0 / (2 * non_zero)
    return rs.choice(np.array([-1.0, 0.0, 1.0], np.float32), shape, p=[p, 1 - 2 * p, p])


def _dense(rs, shape):
    return rs.uniform(-1, 1, shape).astype(np.float32)


def inputs(n: int) -> dict:
    """The numpy inputs of an n-process run: the SpMMs' x, w, b (K = 512·n,
    N = 128·n), one block's masters and input, and the LM's masters."""
    rs = np.random.default_rng(0)
    m, k, cols = 16, 512 * n, 128 * n
    out = {"x": _dense(rs, (m, k)), "w": _tern(rs, (k, cols), 4), "b": _dense(rs, (cols,))}
    d, ff = BLOCK["d_model"], BLOCK["d_ff"]

    def block(d, ff):
        attn = {}
        for name in ("wq", "wk", "wv", "wo"):
            attn[name] = _tern(rs, (d, d))
            attn[name.replace("w", "b")] = _dense(rs, (d,))
        return {"attn": attn, "w_up": _tern(rs, (d, ff)), "b_up": _dense(rs, (ff,)),
                "w_down": _tern(rs, (ff, d)), "b_down": _dense(rs, (d,)),
                "norm1": np.ones(d, np.float32), "norm2": np.ones(d, np.float32)}

    out["block"] = block(d, ff)
    out["block_x"] = _dense(rs, (2, 4, d)) * 0.1
    dl = LM["d_model"]
    out["lm"] = {"embed": _dense(rs, (LM["vocab"], dl)) / np.sqrt(dl),
                 "pos": _dense(rs, (LM["max_len"], dl)) / np.sqrt(dl),
                 "blocks": [block(dl, LM["d_ff"]) for _ in range(LM["n_layers"])],
                 "norm_f": np.ones(dl, np.float32),
                 "head": _tern(rs, (dl, LM["vocab"]))}
    out["lm_toks"] = rs.integers(0, LM["vocab"], (4, 8)).astype(np.int64)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--device", default=None, help="cpu or cuda (default: the card)")
    ap.add_argument("--out", default=None, help="directory for the primary's .npy results")
    args = ap.parse_args()

    import torch

    from smmb_tpu_torch.convert import lm_params_from_jax
    from smmb_tpu_torch.formats.packed import pack_ternary
    from smmb_tpu_torch.kernels.packed_spmm import packed_spmm
    from smmb_tpu_torch.models.lm import TernaryLMConfig, lm_forward, pack_lm
    from smmb_tpu_torch.models.transformer import TernaryBlockConfig, block_forward, pack_block
    from smmb_tpu_torch.parallel import mesh as pm
    from smmb_tpu_torch.parallel.multihost import initialize_multihost, is_primary
    from smmb_tpu_torch.parallel.overlap import sharded_spmm_column_overlapped
    from smmb_tpu_torch.parallel.pp_lm import lm_forward_pp, shard_lm_pp
    from smmb_tpu_torch.parallel.sharded import (
        shard_packed_columns,
        shard_packed_rows,
        sharded_spmm_column,
        sharded_spmm_row,
    )
    from smmb_tpu_torch.parallel.tp_transformer import block_forward_tp, shard_block_tp
    from smmb_tpu_torch.utils.compare import TOL_DENSE, assert_close
    from smmb_tpu_torch.utils.device import resolve_device

    torch.set_num_threads(1)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", args.process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    i, n = args.process_id, args.num_processes
    info = initialize_multihost(args.coordinator, n, i, backend=args.backend)
    print(f"[p{i}] initialized: {info}", flush=True)
    assert info["process_count"] == n, info

    inp = inputs(n)
    results = {}
    mesh = pm.make_mesh(1, n, device=dev)
    x = torch.as_tensor(inp["x"], device=dev)
    b = torch.as_tensor(inp["b"], device=dev)
    w = pack_ternary(inp["w"], dev)
    ref = packed_spmm(x, w, b)

    y = sharded_spmm_column(x, shard_packed_columns(w, mesh), b, mesh=mesh)
    results["column"] = pm.all_gather(y, mesh, pm.MODEL_AXIS, dim=-1)
    assert_close(results["column"], ref, TOL_DENSE, "column")
    print(f"[p{i}] PASS_COLUMN", flush=True)

    xk = pm.local_cols(x, mesh)
    results["row"] = sharded_spmm_row(xk, shard_packed_rows(w, mesh), b, mesh=mesh)
    assert_close(results["row"], ref, TOL_DENSE, "row")
    print(f"[p{i}] PASS_ROW", flush=True)

    y = sharded_spmm_column_overlapped(xk, shard_packed_columns(w, mesh), b, mesh=mesh)
    results["ring"] = pm.all_gather(y, mesh, pm.MODEL_AXIS, dim=-1)
    assert_close(results["ring"], ref, TOL_DENSE, "ring")
    print(f"[p{i}] PASS_RING", flush=True)

    def scaled(got, want, what):
        assert_close(got, want, max(TOL_DENSE, 2e-5 * float(want.abs().max())), what)

    bcfg = TernaryBlockConfig(**BLOCK)
    packed = pack_block(lm_params_from_jax(inp["block"], device=dev))
    bx = torch.as_tensor(inp["block_x"], device=dev)
    sub = pm.make_mesh(1, 2, device=dev)  # processes 0 and 1
    if sub.member:
        results["block"] = block_forward_tp(shard_block_tp(packed, sub), bx, bcfg, mesh=sub)
        scaled(results["block"], block_forward(packed, bx, bcfg), "tp block")
        print(f"[p{i}] PASS_BLOCK", flush=True)

    if n == 4:
        cfg = TernaryLMConfig(**LM)
        lm = pack_lm(lm_params_from_jax(inp["lm"], device=dev))
        toks = torch.as_tensor(inp["lm_toks"], device=dev)
        results["pp"] = lm_forward_pp(shard_lm_pp(lm, mesh), toks, cfg, mesh=mesh,
                                      microbatches=2)
        scaled(results["pp"], lm_forward(lm, toks, cfg), "pp lm")
        print(f"[p{i}] PASS_PP", flush=True)

    if is_primary():
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            for name, val in results.items():
                np.save(os.path.join(args.out, f"{name}.npy"), val.float().cpu().numpy())
        print(f"[p{i}] PRIMARY_OK", flush=True)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(f"MULTIHOST_OK process {i}", flush=True)


if __name__ == "__main__":
    main()
