"""Rank bodies of the port's parallel twins (tests/test_torch_parallel.py,
test_torch_tp.py, test_torch_pp.py, test_torch_dp_train.py,
test_torch_ep_moe.py, test_torch_moe_parallel.py, test_torch_ring.py,
test_torch_lora_parallel.py).

``run_world`` spawns the ranks, which import this module by name: it must
not import JAX or the test files (they import JAX). Each suite loads its
inputs from ``<dir>/inputs.pt`` (numpy arrays and the port's packed trees,
made by the test from JAX's weights), runs every case of its file in one
gloo world on CPU tensors, and returns numpy results from rank 0, each
gathered to the whole array JAX's sharded function returns.
"""

from __future__ import annotations

import collections
import dataclasses
import os

import numpy as np
import torch

from smmb_tpu_torch.formats.packed import pack_ternary
from smmb_tpu_torch.kernels.bcsr_spmm import bcsr_prepare
from smmb_tpu_torch.parallel import mesh as pm
from smmb_tpu_torch.parallel import sharded

CPU = "cpu"


def _load(path):
    return torch.load(os.path.join(path, "inputs.pt"), weights_only=False)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _gather(y, mesh, model_dim=None):
    """A rank's block → the whole array: panels over model along
    ``model_dim`` (None: replicated over model), then rows over data."""
    if model_dim is not None:
        y = pm.all_gather(y, mesh, pm.MODEL_AXIS, dim=model_dim)
    return pm.all_gather(y, mesh, pm.DATA_AXIS, dim=0)


def _raises(fn) -> bool:
    try:
        fn()
    except ValueError:
        return True
    return False


class _Cases:
    """Runs named cases on meshes of the world; rank 0 keeps the results."""

    def __init__(self, world):
        self.world, self.out = world, {}

    def run(self, name, data, model, fn):
        mesh = pm.make_mesh(data, model, device=CPU)  # collective: every rank
        if mesh.member:
            val = fn(mesh)
            if self.world.rank == 0:
                self.out[name] = val


# ------------------------------------------------------------ parallel
def suite_parallel(world, path):
    from smmb_tpu_torch.models.mlp import TernaryMLPConfig, mlp_forward_sharded, shard_mlp
    from smmb_tpu_torch.parallel.bcsr_sharded import shard_bcsr_columns, sharded_bcsr_spmm
    from smmb_tpu_torch.parallel.overlap import sharded_spmm_column_overlapped

    inp = _load(path)
    cases = _Cases(world)
    alpha = inp["alpha"]

    def col(key, bias=True):
        x, w, b = inp[key]

        def fn(mesh):
            p = sharded.shard_packed_columns(pack_ternary(w, CPU), mesh)
            xl = pm.local_rows(_t(x), mesh)
            y = sharded.sharded_spmm_column(xl, p, _t(b) if bias else None, mesh=mesh,
                                            alpha=alpha if bias else None)
            return _gather(y, mesh, -1).numpy()
        return fn

    def row(key):
        x, w, b = inp[key]

        def fn(mesh):
            p = sharded.shard_packed_rows(pack_ternary(w, CPU), mesh)
            xl = pm.local_cols(pm.local_rows(_t(x), mesh), mesh)
            y = sharded.sharded_spmm_row(xl, p, _t(b), mesh=mesh, alpha=alpha)
            return _gather(y, mesh).numpy()
        return fn

    cases.run("mesh_2x4", 2, 4, lambda mesh: (mesh.shape["data"], mesh.shape["model"],
                                              pm.make_mesh(2, device=CPU).shape["model"]))
    for d, m in ((1, 8), (2, 4), (8, 1)):
        cases.run(f"column_{d}x{m}", d, m, col("column"))
    for d, m in ((1, 8), (2, 4)):
        cases.run(f"row_{d}x{m}", d, m, row("row"))
    cases.run("column_no_bias", 1, 8, col("no_bias", bias=False))
    cases.run("shard_validation", 1, 8, lambda mesh: _raises(
        lambda: sharded.shard_packed_columns(pack_ternary(np.zeros((512, 100), np.float32),
                                                          CPU), mesh)))

    def mlp(key, layer_dims, x_key):
        def fn(mesh):
            cfg = TernaryMLPConfig(layer_dims=layer_dims)
            xl = pm.local_rows(_t(inp[x_key]), mesh)
            y = mlp_forward_sharded(shard_mlp(inp[key], mesh), xl, cfg, mesh=mesh)
            return _gather(y, mesh).numpy()
        return fn

    cases.run("mlp_2x4", 2, 4, mlp("mlp", (512, 2048, 512, 1024), "mlp_x"))
    cases.run("mlp_odd_1x2", 1, 2, mlp("mlp_odd", (512, 1024, 512, 1024), "mlp_odd_x"))

    def overlapped(key, counted=False):
        x, w, b = inp[key]

        def fn(mesh):
            p = sharded.shard_packed_columns(pack_ternary(w, CPU), mesh)
            xl = pm.local_cols(pm.local_rows(_t(x), mesh), mesh)
            calls = collections.Counter()
            real = sharded.packed_spmm

            def counting(*a, **k):
                calls["b1"] += 1
                return real(*a, **k)

            pm.CALLS.clear()
            sharded.packed_spmm = counting
            try:
                y = sharded_spmm_column_overlapped(xl, p, _t(b), mesh=mesh, alpha=alpha)
            finally:
                sharded.packed_spmm = real
            rounds = pm.CALLS[("ring_shift", pm.MODEL_AXIS)]
            gathers = pm.CALLS[("all_gather", pm.MODEL_AXIS)]
            y = _gather(y, mesh, -1).numpy()
            return (y, rounds, gathers, calls["b1"]) if counted else y
        return fn

    cases.run("overlap_1x4", 1, 4, overlapped("overlap"))
    cases.run("overlap_counts", 1, 4, overlapped("overlap_counts", counted=True))

    def overlap_bad(mesh):
        x, w, b = inp["overlap_bad"]
        p = sharded.shard_packed_columns(pack_ternary(w, CPU), mesh)
        return _raises(lambda: sharded_spmm_column_overlapped(
            pm.local_cols(_t(x), mesh), p, _t(b), mesh=mesh))

    cases.run("overlap_validation", 1, 4, overlap_bad)

    def bcsr(key, alpha_=alpha):
        x, bc, b = inp[key]

        def fn(mesh):
            shards = shard_bcsr_columns(bcsr_prepare(bc, CPU), mesh)
            y = sharded_bcsr_spmm(pm.local_rows(_t(x), mesh), shards, _t(b), mesh=mesh,
                                  alpha=alpha_)
            return _gather(y, mesh, -1).numpy()
        return fn

    for d, m in ((1, 4), (2, 4)):
        cases.run(f"bcsr_{d}x{m}", d, m, bcsr("bcsr"))
    cases.run("bcsr_empty", 1, 4, bcsr("bcsr_empty"))
    cases.run("bcsr_empty_no_alpha", 1, 4, bcsr("bcsr_empty", None))
    cases.run("bcsr_validation", 1, 8, lambda mesh: _raises(
        lambda: shard_bcsr_columns(bcsr_prepare(inp["bcsr_bad"], CPU), mesh)))
    return cases.out


# ------------------------------------------------------------ TP
def suite_tp(world, path):
    from smmb_tpu_torch.models.lm import TernaryLMConfig
    from smmb_tpu_torch.models.transformer import TernaryBlockConfig
    from smmb_tpu_torch.parallel import tp_transformer as tp

    inp = _load(path)
    cases = _Cases(world)
    cfg = TernaryBlockConfig(**inp["block_cfg"])
    gqa = dataclasses.replace(cfg, n_kv_heads=2)
    lm_cfg = TernaryLMConfig(**inp["lm_cfg"])
    small = TernaryLMConfig(**inp["small_cfg"])

    def block(key, bcfg, x_key, use_flash=False):
        def fn(mesh):
            y = tp.block_forward_tp(tp.shard_block_tp(inp[key], mesh),
                                    pm.local_rows(_t(inp[x_key]), mesh), bcfg, mesh=mesh,
                                    use_kernel=False, use_flash=use_flash)
            return _gather(y, mesh).numpy()
        return fn

    for d, m in ((2, 2), (4, 2), (1, 2)):
        cases.run(f"block_{d}x{m}", d, m, block("block", cfg, "block_x"))
    cases.run("block_kernel", 2, 2, lambda mesh: _gather(tp.block_forward_tp(
        tp.shard_block_tp(inp["block_k"], mesh), pm.local_rows(_t(inp["block_k_x"]), mesh),
        cfg, mesh=mesh, use_kernel=True), mesh).numpy())
    cases.run("block_qat", 2, 2, block("block_qat", cfg, "block_x"))
    cases.run("block_bad_heads", 1, 8, lambda mesh: _raises(
        lambda: tp.shard_block_tp(inp["block"], mesh)))
    cases.run("block_gqa", 2, 2, block("block_gqa", gqa, "gqa_x"))
    cases.run("block_flash", 2, 2, block("block", cfg, "block_x", use_flash=True))

    def decode(key, bcfg, x_key):
        def fn(mesh):
            sh = tp.shard_block_tp(inp[key], mesh)
            x = pm.local_rows(_t(inp[x_key]), mesh)
            cache = tp.init_block_cache_tp(bcfg, inp[x_key].shape[0], 8, mesh)
            _, cache = tp.block_prefill_tp(sh, x[:, :-1], cache, bcfg, mesh=mesh,
                                           use_kernel=False)
            y_t, _ = tp.block_decode_step_tp(sh, x[:, -1:], cache, bcfg, mesh=mesh,
                                             use_kernel=False)
            return _gather(y_t[:, 0], mesh).numpy(), tuple(cache["k"].shape)
        return fn

    cases.run("decode_gqa", 1, 2, decode("decode_gqa", gqa, "decode_gqa_x"))
    cases.run("decode", 2, 2, decode("decode", cfg, "decode_x"))

    def lm_fwd(mesh):
        from smmb_tpu_torch.models.lm import lm_forward

        sh = tp.shard_lm_tp(inp["lm"], mesh)
        y = tp.lm_forward_tp(sh, pm.local_rows(_t(inp["lm_toks"]), mesh), lm_cfg, mesh=mesh,
                             use_kernel=False)
        single = lm_forward(inp["lm"], _t(inp["lm_toks"]).long(), lm_cfg, use_kernel=False)
        return _gather(y, mesh).numpy(), single.numpy()

    cases.run("lm_forward", 2, 2, lm_fwd)

    def lm_decode(mesh):
        sh = tp.shard_lm_tp(inp["lm"], mesh)
        toks = pm.local_rows(_t(inp["lm_toks"]), mesh)
        cache = tp.lm_init_cache_tp(lm_cfg, inp["lm_toks"].shape[0], mesh)
        _, cache = tp.lm_prefill_tp(sh, toks[:, :-1], cache, lm_cfg, mesh=mesh,
                                    use_kernel=False)
        logits, _ = tp.lm_decode_step_tp(sh, toks[:, -1], cache, lm_cfg, mesh=mesh,
                                         use_kernel=False)
        return _gather(logits, mesh).numpy()

    cases.run("lm_decode", 2, 2, lm_decode)

    def gen(key, lcfg, toks_key, steps, **kw):
        def fn(mesh):
            sh = tp.shard_lm_tp(inp[key], mesh)
            mask = kw.pop("prompt_mask", None)
            if mask is not None:
                kw["prompt_mask"] = pm.local_rows(_t(mask), mesh)
            out = tp.generate_tp(sh, pm.local_rows(_t(inp[toks_key]), mesh), lcfg, steps,
                                 mesh=mesh, use_kernel=False, **kw)
            return _gather(out, mesh).numpy()
        return fn

    cases.run("generate", 2, 2, gen("lm", lm_cfg, "gen_toks", 4))
    cases.run("generate_plain", 1, 2, gen("small", small, "small_toks", 6))
    cases.run("generate_flash", 1, 2, gen("small", small, "small_toks", 6, use_flash=True))
    cases.run("generate_kv_quant", 1, 2, gen("small_q", small, "small_q_toks", 6,
                                              kv_quant=True))
    cases.run("kv_quant_cache", 1, 2, lambda mesh: [
        (str(c["kv"].dtype), "kv_scale" in c)
        for c in tp.lm_init_cache_tp(small, 2, mesh, quantized=True)])
    cases.run("generate_ragged", 2, 2, gen("lm", lm_cfg, "ragged_toks", 5,
                                           prompt_mask=inp["ragged_mask"]))
    return cases.out


# ------------------------------------------------------------ PP
def suite_pp(world, path):
    from smmb_tpu_torch.models.lm import TernaryLMConfig
    from smmb_tpu_torch.parallel.pp_lm import lm_forward_pp, shard_lm_pp

    inp = _load(path)
    cases = _Cases(world)
    cfg = TernaryLMConfig(**inp["cfg"])

    def pp(key, toks_key, u, use_kernel):
        def fn(mesh):
            y = lm_forward_pp(shard_lm_pp(inp[key], mesh),
                              pm.local_rows(_t(inp[toks_key]), mesh), cfg, mesh=mesh,
                              microbatches=u, use_kernel=use_kernel)
            return _gather(y, mesh).numpy()
        return fn

    for d, m, u in ((1, 2, 2), (2, 2, 2), (1, 2, 4)):
        cases.run(f"pp_{d}x{m}_u{u}", d, m, pp("lm", "toks", u, False))
    cases.run("pp_kernel", 1, 2, pp("lm_k", "toks_k", 2, True))
    cases.run("pp_uneven", 1, 4, lambda mesh: _raises(lambda: shard_lm_pp(inp["lm"], mesh)))
    cases.run("pp_moe", 1, 2, lambda mesh: _gather(lm_forward_pp(
        shard_lm_pp(inp["lm_moe"], mesh), pm.local_rows(_t(inp["toks_moe"]), mesh),
        TernaryLMConfig(**inp["moe_cfg"]), mesh=mesh, microbatches=2, use_kernel=False),
        mesh).numpy())
    return cases.out


# ------------------------------------------------------------ EP
def _error(fn):
    """The message of the ValueError ``fn`` raises (None if it raises none)."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def suite_ep(world, path):
    from smmb_tpu_torch.models.moe import TernaryMoEConfig, moe_forward
    from smmb_tpu_torch.parallel.ep_moe import moe_forward_ep, shard_moe_ep

    inp = _load(path)
    cases = _Cases(world)

    def ep(key, x_key, cfg_key):
        def fn(mesh):
            cfg = TernaryMoEConfig(**inp[cfg_key])
            y = moe_forward_ep(shard_moe_ep(inp[key], mesh), pm.local_rows(_t(inp[x_key]), mesh),
                               cfg, mesh=mesh, use_kernel=False)
            return _gather(y, mesh).numpy()
        return fn

    for d, m in ((1, 2), (1, 4), (2, 2)):
        cases.run(f"ep_{d}x{m}", d, m, ep("moe", "x", "cfg"))
    cases.run("ep_top2_2x4", 2, 4, ep("moe_top2", "x_top2", "cfg_top2"))
    cases.run("ep_uneven", 1, 8, lambda mesh: _error(lambda: shard_moe_ep(inp["moe"], mesh)))

    def bitwise(key, x_key, cfg_key):
        def fn(mesh):
            cfg = TernaryMoEConfig(**inp[cfg_key])
            x = _t(inp[x_key])
            y = moe_forward_ep(shard_moe_ep(inp[key], mesh), x, cfg, mesh=mesh,
                               use_kernel=False)
            return bool(torch.equal(y, moe_forward(inp[key], x, cfg, use_kernel=False)))
        return fn

    cases.run("ep_bitwise_top1", 1, 4, bitwise("moe", "x", "cfg"))
    cases.run("ep_bitwise_top2", 1, 8, bitwise("moe_top2", "x_top2", "cfg_top2"))
    return cases.out


# ------------------------------------------------------------ MoE blocks under TP and SP
def suite_moe_parallel(world, path):
    from smmb_tpu_torch.models.lm import TernaryLMConfig
    from smmb_tpu_torch.models.moe import TernaryMoEConfig
    from smmb_tpu_torch.models.moe_block import TernaryMoEBlockConfig
    from smmb_tpu_torch.parallel import sp_block
    from smmb_tpu_torch.parallel import tp_moe
    from smmb_tpu_torch.parallel import tp_transformer as tp
    from smmb_tpu_torch.parallel.ep_moe import moe_forward_ep, shard_moe_ep
    from smmb_tpu_torch.parallel.ring_attention import local_seq, ring_attention

    inp = _load(path)
    cases = _Cases(world)
    cfgs = {k: TernaryMoEBlockConfig(**v) for k, v in inp["block_cfgs"].items()}
    lms = {k: TernaryLMConfig(**v) for k, v in inp["lm_cfgs"].items()}

    cases.run("tp_rejects_moe", 1, 2, lambda mesh: _error(
        lambda: tp.shard_block_tp(inp["lm_tp"]["blocks"][0], mesh)))

    def sp(key, x_key, cfg):
        def fn(mesh):
            y = sp_block.block_forward_sp(inp[key], local_seq(pm.local_rows(_t(inp[x_key]), mesh),
                                                              mesh),
                                          cfg, mesh=mesh, use_kernel=False)
            return _gather(y, mesh, 1).numpy()
        return fn

    cases.run("sp_block", 2, 4, sp("sp_block", "sp_x", cfgs["sp"]))

    def sp_lm(mesh):
        y = sp_block.lm_forward_sp(inp["sp_lm"], local_seq(_t(inp["sp_toks"]).long(), mesh),
                                   lms["sp"], mesh=mesh, use_kernel=False)
        return _gather(y, mesh, 1).numpy()

    cases.run("sp_lm", 1, 8, sp_lm)

    def tpep(key, x_key, cfg, use_kernel=False):
        def fn(mesh):
            y = tp_moe.moe_block_forward_tp(tp_moe.shard_moe_block_tp(inp[key], mesh),
                                            pm.local_rows(_t(inp[x_key]), mesh), cfg, mesh=mesh,
                                            use_kernel=use_kernel)
            return _gather(y, mesh).numpy()
        return fn

    cases.run("tpep", 2, 2, tpep("tpep", "tpep_x", cfgs["tpep"]))
    cases.run("tpep_kernel", 1, 2, tpep("tpep_k", "tpep_k_x", cfgs["tpep_k"], use_kernel=True))

    def tpep_decode(mesh):
        cfg = cfgs["tpep_dec"]
        sh = tp_moe.shard_moe_block_tp(inp["tpep_dec"], mesh)
        x = pm.local_rows(_t(inp["tpep_dec_x"]), mesh)
        cache = tp_moe.init_moe_block_cache_tp(cfg, x.shape[0] * mesh.data, 16, mesh)
        y, cache = tp_moe.moe_block_prefill_tp(sh, x[:, :6], cache, cfg, mesh=mesh,
                                               use_kernel=False)
        ys = [y]
        for i in range(6, x.shape[1]):
            y, cache = tp_moe.moe_block_decode_step_tp(sh, x[:, i:i + 1], cache, cfg, mesh=mesh,
                                                       use_kernel=False)
            ys.append(y)
        return _gather(torch.cat(ys, dim=1), mesh).numpy()

    cases.run("tpep_decode", 2, 2, tpep_decode)

    def gen(key, lcfg, toks_key, steps, **kw):
        def fn(mesh):
            out = tp.generate_tp(tp.shard_lm_tp(inp[key], mesh),
                                 pm.local_rows(_t(inp[toks_key]).long(), mesh), lcfg, steps,
                                 mesh=mesh, use_kernel=False, **kw)
            return _gather(out, mesh).numpy()
        return fn

    cases.run("generate_tp", 2, 2, gen("lm_tp", lms["tp"], "tp_toks", 5))
    cases.run("generate_tp_kv_quant", 1, 2, gen("lm_q", lms["q"], "q_toks", 4, kv_quant=True))

    def ragged(mesh):
        toks = _t(inp["tp_toks"]).long()
        return _error(lambda: tp.generate_tp(
            tp.shard_lm_tp(inp["lm_tp"], mesh), toks, lms["tp"], 2, mesh=mesh,
            use_kernel=False, prompt_mask=torch.ones(toks.shape, dtype=torch.bool)))

    cases.run("tp_ragged_moe", 1, 2, ragged)

    def lora(mesh):
        adapted = inp["lora_block"]
        x = torch.zeros((1, 2, 1024))
        return (_error(lambda: tp_moe.shard_moe_block_tp(adapted, mesh)),
                _error(lambda: tp_moe.moe_block_forward_tp(adapted, x, cfgs["lora"], mesh=mesh,
                                                           use_kernel=False)))

    cases.run("tpep_lora", 1, 2, lora)

    # the collectives a call issues, counted by the mesh
    def counted(fn):
        pm.CALLS.clear()
        fn()
        return {f"{op} {axis}": c for (op, axis), c in pm.CALLS.items()}

    def counts(mesh):
        ecfg = TernaryMoEConfig(**inp["ep_cfg"])
        x = _t(inp["ep_x"])
        ep_sh = shard_moe_ep(inp["ep_moe"], mesh)
        tp_sh = tp_moe.shard_moe_block_tp(inp["tpep"], mesh)
        xb = _t(inp["tpep_x"])
        q = local_seq(_t(inp["ring_q"]), mesh)
        k = local_seq(_t(inp["ring_k"]), mesh)
        return {"ep": counted(lambda: moe_forward_ep(ep_sh, x, ecfg, mesh=mesh, use_kernel=False)),
                "tpep_block": counted(lambda: tp_moe.moe_block_forward_tp(
                    tp_sh, xb, cfgs["tpep"], mesh=mesh, use_kernel=False)),
                "ring": counted(lambda: ring_attention(q, k, k, mesh=mesh))}

    cases.run("counts", 1, 2, counts)
    cases.run("counts_ring_1x4", 1, 4, lambda mesh: counted(lambda: ring_attention(
        local_seq(_t(inp["ring_q"]), mesh), local_seq(_t(inp["ring_k"]), mesh),
        local_seq(_t(inp["ring_k"]), mesh), mesh=mesh)))
    return cases.out


# ------------------------------------------------------------ SP (ring attention)
def suite_ring(world, path):
    from smmb_tpu_torch.models.attention import TernaryAttentionConfig
    from smmb_tpu_torch.models.lm import TernaryLMConfig
    from smmb_tpu_torch.models.transformer import TernaryBlockConfig
    from smmb_tpu_torch.parallel import sp_block
    from smmb_tpu_torch.parallel.ring_attention import (
        attention_forward_sp,
        local_seq,
        ring_attention,
    )

    inp = _load(path)
    cases = _Cases(world)

    def seq(a, mesh):
        return local_seq(pm.local_rows(_t(a), mesh), mesh)

    def ring(key, causal):
        def fn(mesh):
            q, k, v = (seq(a, mesh) for a in inp[key])
            return _gather(ring_attention(q, k, v, mesh=mesh, causal=causal), mesh, 1).numpy()
        return fn

    for d, m in ((1, 2), (1, 4), (2, 4)):
        for causal in (True, False):
            cases.run(f"ring_{d}x{m}_{causal}", d, m, ring("qkv", causal))
    cases.run("ring_1x1", 1, 1, ring("qkv_1", True))
    for causal in (True, False):
        cases.run(f"ring_gqa_{causal}", 1, 4, ring("qkv_gqa", causal))

    def attn(key, x_key, use_kernel=False):
        def fn(mesh):
            cfg = TernaryAttentionConfig(**inp["attn_cfgs"][key])
            y = attention_forward_sp(inp[key], seq(inp[x_key], mesh), cfg, mesh=mesh,
                                     use_kernel=use_kernel)
            return _gather(y, mesh, 1).numpy()
        return fn

    cases.run("attn_gqa", 2, 2, attn("attn_gqa", "attn_gqa_x"))
    for use_kernel in (False, True):
        cases.run(f"attn_{use_kernel}", 2, 2, attn("attn", "attn_x", use_kernel))

    def block(key, x_key):
        def fn(mesh):
            cfg = TernaryBlockConfig(**inp["block_cfgs"][key])
            y = sp_block.block_forward_sp(inp[key], seq(inp[x_key], mesh), cfg, mesh=mesh,
                                          use_kernel=False)
            return _gather(y, mesh, 1).numpy()
        return fn

    for key in ("block", "block_rope", "block_window"):
        cases.run(key, 2, 4, block(key, key + "_x"))
    cases.run("ragged_t", 1, 8, lambda mesh: _error(lambda: local_seq(_t(inp["ragged_x"]),
                                                                       mesh)))

    def lm(key, toks_key, use_kernel):
        def fn(mesh):
            cfg = TernaryLMConfig(**inp["lm_cfgs"][key])
            y = sp_block.lm_forward_sp(inp[key], seq(inp[toks_key], mesh).long(), cfg, mesh=mesh,
                                       use_kernel=use_kernel)
            return _gather(y, mesh, 1).numpy()
        return fn

    cases.run("lm", 1, 8, lm("lm", "lm_toks", False))
    cases.run("lm_kernel", 1, 4, lm("lm_k", "lm_k_toks", True))
    return cases.out


# ------------------------------------------------------------ LoRA under TP
def suite_lora_parallel(world, path):
    from smmb_tpu_torch.models.lm import TernaryLMConfig
    from smmb_tpu_torch.parallel import sp_block
    from smmb_tpu_torch.parallel import tp_transformer as tp

    inp = _load(path)
    cases = _Cases(world)
    lms = {k: TernaryLMConfig(**v) for k, v in inp["lm_cfgs"].items()}

    cases.run("sp_rejects", 1, 2, lambda mesh: _error(lambda: sp_block.block_forward_sp(
        inp["sp_model"]["blocks"][0], torch.zeros((1, 2, lms["sp"].d_model)), lms["sp"].block,
        mesh=mesh, use_kernel=False)))

    def fwd(mesh):
        y = tp.lm_forward_tp(tp.shard_lm_tp(inp["fwd_model"], mesh),
                             pm.local_rows(_t(inp["fwd_toks"]).long(), mesh), lms["tp"],
                             mesh=mesh, use_kernel=False)
        return _gather(y, mesh).numpy()

    cases.run("forward", 2, 2, fwd)

    def gen(key, lcfg, toks_key, steps):
        def fn(mesh):
            out = tp.generate_tp(tp.shard_lm_tp(inp[key], mesh),
                                 pm.local_rows(_t(inp[toks_key]).long(), mesh), lcfg, steps,
                                 mesh=mesh, use_kernel=False)
            return _gather(out, mesh).numpy()
        return fn

    cases.run("generate", 2, 2, gen("gen_model", lms["tp"], "gen_toks", 6))
    cases.run("rope_generate", 1, 2, gen("rope_lm", lms["rope"], "rope_toks", 6))

    def shard_shapes(mesh):
        """Each adapter's slices on the rank: (A, B) shapes by target."""
        blk = tp.shard_lm_tp(inp["fwd_model"], mesh)["blocks"][0]
        out = {k: tuple(tuple(a.shape) for a in v[:2]) for k, v in blk["attn"].items()
               if k.endswith("_lora")}
        out.update({k: tuple(tuple(a.shape) for a in v[:2]) for k, v in blk.items()
                    if k.endswith("_lora")})
        return out

    cases.run("shard_shapes", 2, 2, shard_shapes)
    return cases.out


# ------------------------------------------------------------ DP
def suite_dp(world, path):
    from smmb_tpu_torch.convert import lm_params_from_jax
    from smmb_tpu_torch.models.lm import TernaryLMConfig, lm_loss
    from smmb_tpu_torch.parallel.dp_train import make_lm_train_step_dp

    inp = _load(path)
    cases = _Cases(world)
    cfg = TernaryLMConfig(**inp["cfg"])
    toks = _t(inp["toks"])

    def steps(n, lr):
        def fn(mesh):
            params = lm_params_from_jax(inp["params"], device=CPU)
            init_opt, step, place = make_lm_train_step_dp(cfg, mesh, learning_rate=lr)
            p, o, t = place(params, init_opt(params), toks)
            pm.CALLS.clear()
            losses = []
            for _ in range(n):
                p, o, loss = step(p, o, t)
                losses.append(float(loss))
            return losses, int(t.shape[0]), dict(pm.CALLS)
        return fn

    cases.run("dp_8x1", 8, 1, steps(3, 1e-2))
    cases.run("dp_4x2", 4, 2, steps(4, 1e-2))

    def grads(mesh):
        params = lm_params_from_jax(inp["params"], device=CPU)
        init_opt, step, place = make_lm_train_step_dp(cfg, mesh)
        opt = init_opt(params)
        _, _, t = place(params, opt, toks)
        loss = lm_loss(params, t.long(), cfg, aux_weight=0.0)
        loss.backward()
        from smmb_tpu_torch.models.train import param_leaves

        leaves = param_leaves(params)
        flat = torch.cat([p.grad.reshape(-1) for p in leaves])
        flat = pm.all_reduce(flat, mesh, pm.DATA_AXIS) / mesh.shape[pm.DATA_AXIS]
        out, off = [], 0
        for p in leaves:
            out.append(flat[off:off + p.numel()].view_as(p).numpy())
            off += p.numel()
        return out

    cases.run("dp_grads", 8, 1, grads)

    def ragged(mesh):
        params = lm_params_from_jax(inp["params"], device=CPU)
        init_opt, _, place = make_lm_train_step_dp(cfg, mesh)
        try:
            place(params, init_opt(params), toks[:6])
        except ValueError as e:
            return str(e)
        return None

    cases.run("dp_ragged", 8, 1, ragged)
    return cases.out


# ------------------------------------------------------------ on the card
def card_sharded(world):
    """tests/test_torch_cuda.py's sharded B1 and B2 cases on a 2-rank gloo
    world sharing the card (1 × 2 mesh): per mode, the gathered column
    shards against the unsharded B1 call (bitwise), the row and
    ring-overlap shards against the same calls on the plain bodies, and
    the B1 launches a rank; BCSR column shards against their plain bodies,
    and the B2 launches a rank."""
    from smmb_tpu_torch.formats.bcsr import bcsr_from_dense
    from smmb_tpu_torch.kernels.bcsr_spmm import bcsr_spmm_kernel, bcsr_spmm_kernel_plain
    from smmb_tpu_torch.kernels.packed_spmm import packed_spmm, packed_spmm_plain
    from smmb_tpu_torch.parallel import bcsr_sharded
    from smmb_tpu_torch.parallel.overlap import sharded_spmm_column_overlapped
    from smmb_tpu_torch.utils import rng

    dev = world.device
    mesh = pm.make_mesh(1, 2, device=dev)
    gen = rng.make_generator(3, dev)
    x32 = rng.rand_dense(gen, (64, 2048))
    p = pack_ternary(rng.rand_ternary(gen, (2048, 1024), non_zero=4), dev)
    b = rng.rand_dense(gen, (1024,))
    pc, pr = sharded.shard_packed_columns(p, mesh), sharded.shard_packed_rows(p, mesh)
    out = {}
    for name, cdt, xdt in (("f32", torch.float32, torch.float32),
                           ("bf16", torch.bfloat16, torch.bfloat16),
                           ("int8", torch.int8, torch.float32)):
        x = x32.to(xdt)
        xk = pm.local_cols(x, mesh)
        kw = dict(mesh=mesh, alpha=0.2, compute_dtype=cdt)

        def run():
            col = pm.all_gather(sharded.sharded_spmm_column(x, pc, b, **kw), mesh,
                                pm.MODEL_AXIS, dim=-1)
            row = sharded.sharded_spmm_row(xk, pr, b, **kw)
            ring = pm.all_gather(sharded_spmm_column_overlapped(xk, pc, b, **kw), mesh,
                                 pm.MODEL_AXIS, dim=-1)
            return col, row, ring

        packed_spmm.launches = 0
        col, row, ring = run()
        torch.cuda.synchronize()
        launches = packed_spmm.launches
        sharded.packed_spmm = packed_spmm_plain
        try:
            _, row_p, ring_p = run()
        finally:
            sharded.packed_spmm = packed_spmm
        whole = packed_spmm(x, p, b, 0.2, compute_dtype=cdt)

        def rel(a, r):
            return float((a.float() - r.float()).abs().max()) / max(1.0, float(r.float().abs().max()))

        out[name] = {"column_bitwise": bool(torch.equal(col, whole)), "row": rel(row, row_p),
                     "overlap": rel(ring, ring_p), "launches": launches}
    wd = rng.rand_block_ternary(gen, (1024, 2048), block=(128, 128), keep=0.4, non_zero=2)
    prep = bcsr_prepare(bcsr_from_dense(wd, 128, 128, device=dev), device=dev)
    shards = bcsr_sharded.shard_bcsr_columns(prep, mesh)
    xb = rng.rand_dense(gen, (64, 1024))
    bb = rng.rand_dense(gen, (2048,))
    for name, dt in (("bcsr_f32", torch.float32), ("bcsr_bf16", torch.bfloat16)):
        bcsr_spmm_kernel.launches = 0
        y = pm.all_gather(bcsr_sharded.sharded_bcsr_spmm(xb.to(dt), shards, bb, mesh=mesh,
                                                         alpha=0.2), mesh, pm.MODEL_AXIS, dim=-1)
        torch.cuda.synchronize()
        launches = bcsr_spmm_kernel.launches
        ref = pm.all_gather(bcsr_spmm_kernel_plain(xb.to(dt), shards.local,
                                                   sharded._bias_cols(bb, mesh, shards.local.cols),
                                                   0.2), mesh, pm.MODEL_AXIS, dim=-1)
        err = float((y.float() - ref.float()).abs().max()) / max(1.0, float(ref.float().abs().max()))
        out[name] = {"err": err, "launches": launches}
    out["staged"] = dict(pm.STAGED)
    return out


def card_a4b(world):
    """tests/test_torch_cuda.py's expert-parallel and ring cases on a 2-rank
    gloo world sharing the card (1 × 2 mesh): ``moe_forward_ep`` (8
    experts, top-1 and top-2, f32 and bf16) bitwise the single-rank
    ``moe_forward`` with its B1 launches a rank; ``ring_attention`` (causal
    and not, and GQA 8/2 with a window) against ``_attention_math`` on the
    card."""
    from smmb_tpu_torch.kernels.packed_spmm import packed_spmm
    from smmb_tpu_torch.models.attention import TernaryAttentionConfig, _attention_math
    from smmb_tpu_torch.models.moe import TernaryMoEConfig, init_moe, moe_forward, pack_moe
    from smmb_tpu_torch.parallel.ep_moe import moe_forward_ep, shard_moe_ep
    from smmb_tpu_torch.parallel.ring_attention import _ring_body, local_seq
    from smmb_tpu_torch.utils import rng

    dev = world.device
    mesh = pm.make_mesh(1, 2, device=dev)
    out = {}
    for k in (1, 2):
        cfg = TernaryMoEConfig(d_model=512, d_ff=1024, n_experts=8, top_k=k)
        packed = pack_moe(init_moe(rng.make_generator(4, dev), cfg))
        sh = shard_moe_ep(packed, mesh)
        x = rng.rand_dense(rng.make_generator(5, dev), (64, 512)) * 0.5
        for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            packed_spmm.launches = 0
            y = moe_forward_ep(sh, x.to(dt), cfg, mesh=mesh, compute_dtype=dt)
            torch.cuda.synchronize()
            launches = packed_spmm.launches
            ref = moe_forward(packed, x.to(dt), cfg, compute_dtype=dt)
            out[f"ep_top{k}_{name}"] = {"bitwise": bool(torch.equal(y, ref)),
                                        "launches": launches}
    gen = rng.make_generator(6, dev)
    for name, h, kvh, causal, window in (("causal", 8, 8, True, None),
                                         ("non_causal", 8, 8, False, None),
                                         ("gqa_window", 8, 2, True, 100)):
        t, hd = 512, 128
        q = rng.rand_dense(gen, (1, t, h, hd)) * 0.5
        kk, v = (rng.rand_dense(gen, (1, t, kvh, hd)) * 0.5 for _ in range(2))
        cfg = TernaryAttentionConfig(d_model=h * hd, n_heads=h, n_kv_heads=kvh, causal=causal,
                                     window=window)
        y = _ring_body(*(local_seq(a, mesh) for a in (q, kk, v)), mesh, causal, None, window)
        full = _attention_math(q.reshape(1, t, -1), kk.reshape(1, t, -1), v.reshape(1, t, -1),
                               cfg)
        out[f"ring_{name}"] = float((y.reshape(1, t // 2, -1)
                                     - local_seq(full, mesh)).abs().max())
    worst = torch.tensor([max(v for k_, v in out.items() if k_.startswith("ring_"))],
                         dtype=torch.float64, device=dev)
    out["ring_worst"] = float(pm.all_reduce(worst, mesh, pm.MODEL_AXIS, op="max")[0])
    return out
