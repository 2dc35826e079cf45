"""Port parity: the routed ternary MoE layer and block
(smmb_tpu_torch.models.moe, .moe_block) against smmb_tpu.models.moe and
.moe_block.

JAX's masters and packed trees are carried into the port by ``convert``;
inputs are numpy arrays from a seed. JAX's entry points are jitted. The port
runs on CPU tensors, so B1 runs its plain version.

Tolerances:
- routing (slots, dispatch, combine, rank priority, ties): exact, on the
  same logits;
- the serving forward against JAX's ``moe_forward(use_kernel=False)``:
  JAX's own atol 2e-4 (tests/test_moe.py); the bf16 twin holds the dtype
  exactly and the values at 2e-4 as well (the router, the slabs and the
  combine are f32 on both sides; only the experts' sums differ in order);
- the packed experts: words byte-identical to JAX's, scales equal to
  XLA's absmean (1e-5 relative; its CPU mean is off by up to ~5e-6);
- one QAT step: the loss at rtol ``FWD_REL`` = 3e-5, the forward at 3e-5 of
  max(1, max|y|) and every gradient within 3e-5 of the largest |g| of all
  tensors (XLA's CPU absmean is off the exact mean by up to ~5e-6
  relative, tests/test_torch_train.py); trajectories fall in both packages
  and agree within 1e-3 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smmb_tpu.models import moe as jm
from smmb_tpu.models import moe_block as jmb
from smmb_tpu_torch import convert
from smmb_tpu_torch.models import moe as tm
from smmb_tpu_torch.models import moe_block as tmb
from smmb_tpu_torch.models import train as ttrain

torch.set_num_threads(2)
FWD_REL = 3e-5
TRAJ_REL = 1e-3
KW = dict(d_model=128, d_ff=256, n_experts=4)


def _cfgs(**kw):
    return jm.TernaryMoEConfig(**kw), tm.TernaryMoEConfig(**kw)


def _x(seed, shape, scale=0.5):
    return (np.random.default_rng(seed).uniform(-1, 1, shape) * scale).astype(np.float32)


def _moe(seed, jcfg, bump=0.0):
    """JAX masters (numpy, ``+ bump``) and both packages' packed trees."""
    params = jm.init_moe(jax.random.PRNGKey(seed), jcfg)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) + np.float32(bump), params)
    jpacked = jm.pack_moe(jax.tree_util.tree_map(jnp.asarray, params))
    return params, jpacked, convert.packed_lm_from_jax(jpacked, device="cpu")


_JFWD = {}


def _jax_forward(jcfg, no_drop=False, dtype=jnp.float32):
    key = (jcfg, no_drop, dtype)
    if key not in _JFWD:
        _JFWD[key] = jax.jit(lambda p, x: jm.moe_forward(
            p, x, jcfg, use_kernel=False, no_drop=no_drop, compute_dtype=dtype))
    return _JFWD[key]


# ---------------------------------------------------------------- routing


def test_route_top1_positions_match_jax():
    logits = np.asarray([[9.0, 0.0], [9.0, 0.0], [0.0, 9.0], [9.0, 0.0]], np.float32)
    jd, jc = jm.route_top1(jnp.asarray(logits), capacity=2)
    td, tc = tm.route_top1(torch.from_numpy(logits), capacity=2)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    d = td.numpy()
    # tokens 0, 1 fill expert 0's slots 0, 1; token 2 takes expert 1's slot
    # 0; token 3 overflows expert 0 and is dropped
    assert d[0, 0, 0] == 1 and d[1, 0, 1] == 1 and d[2, 1, 0] == 1 and d[3].sum() == 0


def test_route_topk_rank_priority_matches_jax():
    logits = np.asarray([[9.0, 5.0, 0.0], [9.0, 5.0, 0.0]], np.float32)
    jd, jc = jm.route_topk(jnp.asarray(logits), capacity=1, k=2)
    td, tc = tm.route_topk(torch.from_numpy(logits), capacity=1, k=2)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    d = td.numpy()
    assert d[0, 0, 0] == 1 and d[1, 0].sum() == 0 and d[0, 1, 0] == 1 and d[1, 1].sum() == 0
    np.testing.assert_allclose(tc.numpy()[0].sum(), 1.0, atol=1e-6)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_routing_matches_jax_on_random_logits(k):
    """Dispatch and combine of 64 tokens over 8 experts, at a capacity
    that drops some, equal to JAX's."""
    logits = _x(5, (64, 8), scale=3.0)
    cap = jm.TernaryMoEConfig(d_model=8, d_ff=8, n_experts=8, top_k=k,
                              capacity_factor=0.5).capacity(64)
    jd, jc = jm._route(jnp.asarray(logits), cap, k)
    td, tc = tm._route(torch.from_numpy(logits), cap, k)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6, atol=0)
    assert td.numpy().sum() < 64 * k  # the capacity dropped some


def test_routing_tie_order_on_equal_gates():
    """Equal gates: top-1 takes the lowest expert (argmax's first maximum);
    top-k the lowest k, in index order (``lax.top_k``'s order)."""
    logits = np.zeros((3, 4), np.float32)
    logits[1, 2] = logits[1, 3] = 1.0  # a tie between experts 2 and 3
    for k in (1, 2, 3):
        jd, jc = jm._route(jnp.asarray(logits), 8, k)
        td, tc = tm._route(torch.from_numpy(logits), 8, k)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    expert, _, _, _ = tm._assign(torch.from_numpy(logits), 8, 3)
    assert expert.tolist() == [[0, 1, 2], [2, 3, 0], [0, 1, 2]]


def test_capacity_matches_jax():
    for n in (1, 7, 32, 100, 1024):
        for k in (1, 2):
            for f in (1.0, 1.25, 4.0):
                jc, tc = _cfgs(**KW, top_k=k, capacity_factor=f)
                assert tc.capacity(n) == jc.capacity(n), (n, k, f)


def test_load_balance_loss_and_gradient_match_jax():
    logits = _x(7, (48, 6), scale=2.0)
    jl, jg = jax.value_and_grad(jm.load_balance_loss)(jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_(True)
    tl = tm.load_balance_loss(t)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), atol=1e-7, rtol=0)
    # uniform routing is its minimum, 1
    assert abs(float(tm.load_balance_loss(torch.zeros(8, 4))) - 1.0) < 1e-6


# ---------------------------------------------------------------- serving


@pytest.mark.parametrize("top_k,seed", [(1, 3), (2, 40)], ids=["top1", "top2"])
@pytest.mark.parametrize("no_drop", [False, True], ids=["capacity", "no_drop"])
def test_moe_forward_matches_jax_jnp(top_k, seed, no_drop):
    jcfg, tcfg = _cfgs(**KW, top_k=top_k)
    _, jpacked, tpacked = _moe(seed, jcfg)
    x = _x(seed + 1, (32, 128))
    want = np.asarray(_jax_forward(jcfg, no_drop)(jpacked, jnp.asarray(x)))
    got = tm.moe_forward(tpacked, torch.from_numpy(x), tcfg, no_drop=no_drop)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)
    plain = tm.moe_forward(tpacked, torch.from_numpy(x), tcfg, no_drop=no_drop,
                           use_kernel=False)
    np.testing.assert_allclose(plain.numpy(), want, atol=2e-4, rtol=0)


def test_moe_kernel_path_on_cpu_matches_jax_jnp():
    """The port's kernel route on CPU tensors (B1's plain version) against
    JAX's jnp path (tests/test_moe.py:77's pair)."""
    jcfg, tcfg = _cfgs(**KW)
    _, jpacked, tpacked = _moe(5, jcfg)
    x = _x(6, (32, 128))
    want = np.asarray(_jax_forward(jcfg)(jpacked, jnp.asarray(x)))
    got = tm.moe_forward(tpacked, torch.from_numpy(x), tcfg, use_kernel=True)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)


def test_no_drop_rows_do_not_depend_on_the_call():
    """Serving routes each token alone: a token's row of a 32-token call
    equals its 1-token call (to the plain products' order)."""
    _, tcfg = _cfgs(**KW, top_k=2)
    _, _, tpacked = _moe(8, jm.TernaryMoEConfig(**KW, top_k=2))
    x = torch.from_numpy(_x(9, (32, 128)))
    full = tm.moe_forward(tpacked, x, tcfg, no_drop=True)
    ones = torch.cat([tm.moe_forward(tpacked, x[i:i + 1], tcfg, no_drop=True)
                      for i in range(0, 32, 7)])
    np.testing.assert_allclose(ones.numpy(), full[0:32:7].numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("quantize", [False, True])
def test_pack_moe_planes_byte_identical(quantize):
    jcfg, _ = _cfgs(**KW)
    params, _, _ = _moe(7, jcfg, bump=0.01)
    jpacked = jm.pack_moe(jax.tree_util.tree_map(jnp.asarray, params), quantize=quantize)
    tpacked = tm.pack_moe(convert.lm_params_from_jax(params, device="cpu"), quantize=quantize)
    for name in ("w_up", "w_down"):
        jw, tw = jpacked[name], tpacked[name]
        assert tw.data.shape == np.asarray(jw.data).shape and tw.data.dtype == torch.int8
        assert (tw.rows, tw.cols) == (jw.rows, jw.cols)
        np.testing.assert_array_equal(tw.data.numpy(), np.asarray(jw.data))
        for e in range(KW["n_experts"]):
            np.testing.assert_array_equal(tm.expert_plane(tw, e).data.numpy(),
                                          np.asarray(jw.data[e]))
        # XLA's CPU absmean is off the exact mean by up to ~5e-6 relative
        s = "s" + name[1:]
        np.testing.assert_allclose(tpacked[s].numpy(), np.asarray(jpacked[s]), rtol=1e-5)
    x = _x(8, (32, 128))
    y = tm.moe_forward(tpacked, torch.from_numpy(x), tm.TernaryMoEConfig(**KW))
    assert bool(torch.isfinite(y).all()) and float(y.abs().max()) > 0


def test_bf16_dtype_flow_matches_jax():
    """bf16 x: JAX's router, dispatch and combine promote to f32, so
    ``moe_forward`` returns f32, and ``moe_block_forward``'s residual
    stream is f32 after the MoE half. The port gives the same dtypes and
    values."""
    jcfg, tcfg = _cfgs(**KW, top_k=2)
    _, jpacked, tpacked = _moe(11, jcfg)
    x = _x(12, (16, 128))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = _jax_forward(jcfg, True, jnp.bfloat16)(jpacked, xb)
    got = tm.moe_forward(tpacked, torch.from_numpy(x).to(torch.bfloat16), tcfg,
                         compute_dtype=torch.bfloat16, no_drop=True)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)

    bkw = dict(d_model=128, n_heads=2, d_ff=128, n_experts=4, top_k=2)
    jbcfg, tbcfg = jmb.TernaryMoEBlockConfig(**bkw), tmb.TernaryMoEBlockConfig(**bkw)
    jblk = jmb.pack_moe_block(jmb.init_moe_block(jax.random.PRNGKey(13), jbcfg))
    tblk = convert.packed_lm_from_jax(jblk, device="cpu")
    xs = _x(14, (2, 8, 128))
    want = jax.jit(lambda p, x: jmb.moe_block_forward(
        p, x, jbcfg, compute_dtype=jnp.bfloat16, use_kernel=False))(
            jblk, jnp.asarray(xs).astype(jnp.bfloat16))
    got = tmb.moe_block_forward(tblk, torch.from_numpy(xs).to(torch.bfloat16), tbcfg,
                                compute_dtype=torch.bfloat16)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    # bf16 attention math before the f32 MoE half: one bf16 ulp of the
    # attention output (2**-8 of its magnitude) feeds the router and experts
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2.0 ** -7 * max(1.0, float(np.abs(want).max())))


# ---------------------------------------------------------------- training


def _jax_loss_and_grads(jcfg, params, x, y, aux_weight=1e-2):
    def loss_fn(p):
        pred, aux = jm.qat_moe_forward(p, x, jcfg)
        return jnp.mean((pred - y) ** 2) + aux_weight * aux, pred

    (loss, pred), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return loss, pred, grads


@pytest.mark.parametrize("top_k,seed", [(1, 17), (2, 44)], ids=["top1", "top2"])
def test_moe_train_step_one_step_matches_jax(top_k, seed):
    kw = dict(d_model=64, d_ff=128, n_experts=4, top_k=top_k)
    jcfg, tcfg = _cfgs(**kw)
    params, _, _ = _moe(seed, jcfg, bump=0.01)
    x, y = _x(seed + 1, (32, 64)), _x(seed + 2, (32, 64))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jl, jpred, jg = _jax_loss_and_grads(jcfg, jp, jnp.asarray(x), jnp.asarray(y))
    tp = convert.lm_params_from_jax(params, device="cpu")
    with torch.no_grad():
        tpred, aux = tm.qat_moe_forward(tp, torch.from_numpy(x), tcfg)
    jpred = np.asarray(jpred)
    assert float(aux) >= 0
    np.testing.assert_allclose(tpred.numpy(), jpred, rtol=0,
                               atol=FWD_REL * max(1.0, float(np.abs(jpred).max())))
    init_opt, step = tm.make_moe_train_step(tcfg, learning_rate=1e-2)
    tp, _, loss = step(tp, init_opt(tp), torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(loss), float(jl), rtol=FWD_REL)
    tleaves = jax.tree_util.tree_leaves(tp, is_leaf=lambda a: isinstance(a, torch.Tensor))
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(tleaves) == len(jleaves) == 5
    gmax = max(float(np.abs(np.asarray(g)).max()) for g in jleaves)
    for t, g in zip(tleaves, jleaves):
        assert float(np.abs(t.grad.numpy() - np.asarray(g)).max()) <= FWD_REL * gmax
    assert float(tp["router"].grad.abs().max()) > 0  # the router trains


@pytest.mark.parametrize("top_k,seed,n,steps", [(1, 17, 32, 8), (2, 44, 16, 6)],
                         ids=["top1", "top2"])
def test_moe_train_step_reduces_loss_like_jax(top_k, seed, n, steps):
    kw = dict(d_model=64, d_ff=128, n_experts=4, top_k=top_k)
    jcfg, tcfg = _cfgs(**kw)
    params, _, _ = _moe(seed, jcfg, bump=0.01)
    x, y = _x(seed + 1, (n, 64)), _x(seed + 2, (n, 64))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    j_init, j_step = jm.make_moe_train_step(jcfg, learning_rate=1e-2)
    jstep, jopt = jax.jit(j_step), j_init(jp)
    tp = convert.lm_params_from_jax(params, device="cpu")
    t_init, t_step = tm.make_moe_train_step(tcfg, learning_rate=1e-2)
    topt = t_init(tp)
    jl, tl = [], []
    for _ in range(steps):
        jp, jopt, loss = jstep(jp, jopt, jnp.asarray(x), jnp.asarray(y))
        jl.append(float(loss))
        tp, topt, loss = t_step(tp, topt, torch.from_numpy(x), torch.from_numpy(y))
        tl.append(float(loss))
    assert jl[-1] < jl[0] and tl[-1] < tl[0], (jl, tl)
    np.testing.assert_allclose(tl, jl, rtol=TRAJ_REL)
    with torch.no_grad():
        out = tm.moe_forward(tm.pack_moe(tp, quantize=True), torch.from_numpy(x), tcfg)
        _, aux = tm.qat_moe_forward(tp, torch.from_numpy(x), tcfg)
    assert bool(torch.isfinite(out).all()) and float(aux) >= 0
    assert all(t.grad is not None for t in ttrain.param_leaves(tp))


def test_qat_moe_block_forward_matches_jax():
    bkw = dict(d_model=64, n_heads=2, d_ff=128, n_experts=4, top_k=2)
    jbcfg, tbcfg = jmb.TernaryMoEBlockConfig(**bkw), tmb.TernaryMoEBlockConfig(**bkw)
    params = jmb.init_moe_block(jax.random.PRNGKey(21), jbcfg)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) + np.float32(0.01), params)
    x = _x(22, (2, 16, 64))
    jy, jaux = jax.jit(lambda p, x: jmb.qat_moe_block_forward(p, x, jbcfg, attn_chunk=8))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    ty, taux = tmb.qat_moe_block_forward(convert.lm_params_from_jax(params, device="cpu"),
                                         torch.from_numpy(x), tbcfg, attn_chunk=8)
    jy = np.asarray(jy)
    np.testing.assert_allclose(ty.detach().numpy(), jy, rtol=0,
                               atol=FWD_REL * max(1.0, float(np.abs(jy).max())))
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
