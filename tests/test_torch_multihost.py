"""Port parity: the multi-process run of the parallel layer
(scripts/torch_multihost_worker.py over smmb_tpu_torch.parallel.multihost)
— the twins of tests/test_multihost.py:27,76.

2 and 4 worker processes on CPU, connected by ``initialize_multihost``
over a localhost TCP coordinator with the gloo backend. Each worker checks
the column, row and ring-overlapped SpMMs, a TP block (processes 0 and 1)
and, with 4 processes, a 4-stage PP LM against the port's single-process
results; the primary writes its gathered results, which are held here
against JAX's sharded functions on the virtual CPU mesh (TOL_DENSE; the
block at max(TOL_DENSE, 2e-5·max|ref|)).
"""

import importlib.util
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smmb_tpu.formats.packed import pack_ternary
from smmb_tpu.models.transformer import TernaryBlockConfig, pack_block
from smmb_tpu.parallel import (
    make_mesh,
    shard_packed_columns,
    shard_packed_rows,
    sharded_spmm_column,
    sharded_spmm_row,
)
from smmb_tpu.parallel.tp_transformer import block_forward_tp, shard_block_tp
from smmb_tpu.utils.compare import TOL_DENSE, assert_close

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "scripts", "torch_multihost_worker.py")


def _worker_module():
    spec = importlib.util.spec_from_file_location("torch_multihost_worker", WORKER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run(n, out):
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    procs = [subprocess.Popen(
        [sys.executable, WORKER, "--process-id", str(i), "--num-processes", str(n),
         "--coordinator", f"localhost:{port}", "--backend", "gloo", "--device", "cpu",
         "--out", str(out)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{text}"
        assert f"MULTIHOST_OK process {i}" in text, text
    assert sum("PRIMARY_OK" in t for t in outs) == 1, outs
    return outs


def _held_against_jax(n, out):
    inp = _worker_module().inputs(n)
    mesh = make_mesh(1, n, devices=jax.devices()[:n])
    x, b = jnp.asarray(inp["x"]), jnp.asarray(inp["b"])
    w = pack_ternary(inp["w"])
    col = sharded_spmm_column(x, shard_packed_columns(w, mesh), b, mesh=mesh)
    assert_close(np.load(out / "column.npy"), np.asarray(col), TOL_DENSE, "column vs JAX")
    row = sharded_spmm_row(x, shard_packed_rows(w, mesh), b, mesh=mesh)
    assert_close(np.load(out / "row.npy"), np.asarray(row), TOL_DENSE, "row vs JAX")
    assert_close(np.load(out / "ring.npy"), np.asarray(col), TOL_DENSE, "ring vs JAX")
    sub = make_mesh(1, 2, devices=jax.devices()[:2])
    packed = pack_block(jax.tree.map(jnp.asarray, inp["block"]))
    blk = np.asarray(block_forward_tp(shard_block_tp(packed, sub), jnp.asarray(inp["block_x"]),
                                      TernaryBlockConfig(d_model=1024, n_heads=4, d_ff=1024),
                                      mesh=sub, use_kernel=False))
    assert_close(np.load(out / "block.npy"), blk,
                 max(TOL_DENSE, 2e-5 * float(np.abs(blk).max())), "TP block vs JAX")


@pytest.mark.parametrize("n", [2, 4])
def test_cpu_multiprocess(tmp_path, n):
    outs = _run(n, tmp_path)
    for i, text in enumerate(outs):
        want = ["PASS_COLUMN", "PASS_ROW", "PASS_RING"]
        if i in (0, 1):
            want.append("PASS_BLOCK")
        if n == 4:
            want.append("PASS_PP")
        for marker in want:
            assert marker in text, f"process {i} missing {marker}:\n{text}"
    _held_against_jax(n, tmp_path)
