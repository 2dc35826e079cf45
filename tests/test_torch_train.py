"""Port parity: the MLP training surface (smmb_tpu_torch.kernels.packed_vjp,
.models.train, .nn's TernaryDense and convert_to_packed) against
smmb_tpu.kernels.packed_vjp, smmb_tpu.models.train and smmb_tpu.nn.

Inputs are numpy arrays from a seed, fed to both packages. JAX's steps are
jitted. The port runs on CPU tensors, so B1 runs its plain version.

Tolerances:
- the packed VJP: y at ``TOL_DENSE`` and dx, db at 1e-3 (tests/test_kernels.py)
  with f32 x; with bf16 x, one bf16 ulp of the largest value, 2**-7 of
  max(1, max|·|): both sides round the same f32 sums (summed in another
  order) to bf16, and db sums the cast bf16 g as JAX does;
- forwards: ``FWD_REL`` = 3e-5 of max(1, max|y|). XLA's CPU mean of |w|
  (its absmean scale) is off the exact mean by up to ~5e-6 relative on
  these masters (0.368455 against 0.368457), torch's by under 1e-7; each
  layer's scale carries that into its output (JAX's ``qat_forward`` is
  1.1e-5 of max|y| off an f64 product here, the port's 2.2e-7);
- one train step: the loss at rtol ``FWD_REL``, gradients at ``FWD_REL`` of
  max|g| and the updated masters at 1e-6, masking entries whose |g| is
  below 1e-6 of max|g| (Adam's first update is about lr·sign(g), so a
  gradient within rounding of 0 can move a whole lr either way);
- a trajectory of 20 steps: the losses fall in both packages and agree
  within 1e-3 relative. Absmean sums in another order can put ``w/scale`` on
  the other side of ±0.5 and flip a code; the count of codes that differ
  at the end is reported (0 on this draw).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smmb_tpu import nn as jnn
from smmb_tpu.kernels import packed_vjp as jvjp
from smmb_tpu.models import attention as jattn
from smmb_tpu.models import mlp as jmlp
from smmb_tpu.models import train as jtrain
from smmb_tpu_torch import convert
from smmb_tpu_torch import nn as tnn
from smmb_tpu_torch.kernels import packed_vjp as tvjp
from smmb_tpu_torch.models import attention as tattn
from smmb_tpu_torch.models import mlp as tmlp
from smmb_tpu_torch.models import train as ttrain
from smmb_tpu_torch.utils.compare import TOL_DENSE

tps = importlib.import_module("smmb_tpu_torch.kernels.packed_spmm")
torch.set_num_threads(2)
ALPHA = 0.2
DIMS = (32, 64, 32)
FWD_REL = 3e-5


def _np(seed, *shapes):
    rs = np.random.default_rng(seed)
    return [rs.uniform(-1, 1, s).astype(np.float32) for s in shapes]


def _tern(seed, shape):
    return np.random.default_rng(seed).choice(np.array([-1.0, 0.0, 1.0], np.float32), shape)


def _close(got, want, tol, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    err = float(np.abs(got.astype(np.float32) - want).max())
    assert err <= tol, f"{what}: max err {err:.3e} > {tol:.3e}"


def _rel(want) -> float:
    return max(1.0, float(np.abs(np.asarray(want, np.float32)).max()))


# ---------------------------------------------------------------- packed VJP

_J = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.mark.parametrize("x_dtype,cdt", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16)], ids=["f32", "f32x-bf16", "bf16"])
def test_packed_linear_vjp_matches_jax(x_dtype, cdt):
    x, b, gy = _np(41, (8, 512), (256,), (8, 256))
    w = _tern(42, (512, 256))
    jwp, jwtp = jvjp.pack_with_transpose(w)
    jlayer = jvjp.make_packed_linear(jwp, jwtp, alpha=ALPHA, compute_dtype=_J[cdt],
                                     use_kernel=False)
    xj = jnp.asarray(x, _J[x_dtype])

    def jloss(x, b):
        return jnp.sum(jlayer(x, b).astype(jnp.float32) * gy)

    jy = jlayer(xj, jnp.asarray(b))
    jgx, jgb = jax.jit(jax.grad(jloss, argnums=(0, 1)))(xj, jnp.asarray(b))

    wp, wtp = tvjp.pack_with_transpose(torch.from_numpy(w))
    np.testing.assert_array_equal(wtp.data.numpy(), np.asarray(jwtp.data))
    layer = tvjp.make_packed_linear(wp, wtp, alpha=ALPHA, compute_dtype=cdt)
    xt = torch.from_numpy(x).to(x_dtype).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    y = layer(xt, bt)
    (y.float() * torch.from_numpy(gy)).sum().backward()
    assert y.dtype == x_dtype and xt.grad.dtype == x_dtype
    if x_dtype == torch.float32:
        tols = (TOL_DENSE, 1e-3, 1e-3)
    else:
        tols = tuple(2.0 ** -7 * _rel(v) for v in (jy, jgx, jgb))
    _close(y, jy, tols[0], "y")
    _close(xt.grad, jgx, tols[1], "dx")
    _close(bt.grad, jgb, tols[2], "db")


def test_packed_linear_without_input_grad_and_plain_route():
    x, b, gy = _np(43, (4, 3, 512), (128,), (4, 3, 128))
    w = _tern(44, (512, 128))
    wp, wtp = tvjp.pack_with_transpose(torch.from_numpy(w))
    grads = []
    for use_kernel in (None, False):
        layer = tvjp.make_packed_linear(wp, wtp, alpha=ALPHA, compute_dtype=torch.float32,
                                        use_kernel=use_kernel)
        xt, bt = torch.from_numpy(x), torch.from_numpy(b).requires_grad_(True)
        (layer(xt, bt) * torch.from_numpy(gy)).sum().backward()
        assert xt.grad is None
        grads.append(bt.grad)
    # db against autograd through the dense product
    bd = torch.from_numpy(b).requires_grad_(True)
    yd = torch.nn.functional.prelu(torch.from_numpy(x) @ torch.from_numpy(w) + bd,
                                   torch.tensor([ALPHA]))
    (yd * torch.from_numpy(gy)).sum().backward()
    for g in grads:
        _close(g, bd.grad.numpy(), 1e-4, "db")


def test_pack_with_transpose_validation():
    w = _tern(45, (64, 32))
    wp, wtp = tvjp.pack_with_transpose(torch.from_numpy(w))
    jwp, jwtp = jvjp.pack_with_transpose(w)
    with pytest.raises(ValueError):
        jvjp.make_packed_linear(jwp, jwp)
    with pytest.raises(ValueError, match="transpose"):
        tvjp.make_packed_linear(wp, wp)
    with pytest.raises(ValueError, match="alpha"):
        tvjp.make_packed_linear(wp, wtp, alpha=-0.1)


@pytest.mark.parametrize("k,n", [(4096, 4096), (1000, 600)])
def test_transpose_planes_shapes_and_piece_alignment(k, n):
    """Wᵀ's planes are padded to the 512-row group; the backward's B1 call
    (K = N of the forward) copies 16-byte pieces at 4096 and loads
    elements where the forward K is not a multiple of 16."""
    w = torch.from_numpy(_tern(46, (k, n)))
    wp, wtp = tvjp.pack_with_transpose(w)
    assert (wtp.rows, wtp.cols) == (n, k)
    assert wtp.data.shape == (-(-n // 512) * 512 // 4, k)
    aligned = tps.pieces_aligned(n, k, 0, 0, torch.bfloat16)
    assert aligned == (k % 16 == 0 and n % 8 == 0)
    assert aligned == (k == 4096)
    gy = torch.from_numpy(_np(47, (2, n))[0])
    dx = tps.packed_spmm(gy, wtp, compute_dtype=torch.float32)
    _close(dx, (gy @ w.t()).numpy(), 1e-4, "g @ W^T through the transpose planes")


# ---------------------------------------------------------------- QAT MLP


def _mlp_params(seed, scale=0.5, shift=0.1):
    """JAX init_mlp masters made f32 (``w·scale + shift``, as the JAX tests)."""
    params = jmlp.init_mlp(jax.random.PRNGKey(seed), jmlp.TernaryMLPConfig(layer_dims=DIMS))
    return {"w": [np.asarray(w) * scale + shift for w in params["w"]],
            "b": [np.asarray(b) for b in params["b"]]}


def _jparams(p):
    return jax.tree_util.tree_map(jnp.asarray, p)


def test_qat_forward_matches_jax():
    p = _mlp_params(5, 0.7, 0.05)
    (x,) = _np(6, (8, DIMS[0]))
    want = np.asarray(jtrain.qat_forward(_jparams(p), jnp.asarray(x), ALPHA))
    got = ttrain.qat_forward(convert.mlp_params_from_jax(p, device="cpu"),
                             torch.from_numpy(x), ALPHA)
    assert torch.isfinite(got).all()
    _close(got, want, FWD_REL * _rel(want), "qat_forward")
    w = torch.tensor([[0.9, -0.05, -2.0], [0.2, 0.0, 0.4]], requires_grad=True)
    t = ttrain.ternarize_ste(w)
    np.testing.assert_array_equal(t.detach().numpy(),
                                  np.asarray(jtrain.ternarize_ste(jnp.asarray(w.detach()))))
    (t * w).sum().backward()
    assert torch.isfinite(w.grad).all()


def _jax_loss_and_grads(p, x, y):
    def loss(params):
        return jnp.mean((jtrain.qat_forward(params, x, ALPHA) - y) ** 2)

    return jax.jit(jax.value_and_grad(loss))(_jparams(p))


def test_train_step_one_step_matches_jax():
    p = _mlp_params(7)
    x, y = _np(8, (64, DIMS[0]), (64, DIMS[-1]))
    jl, jg = _jax_loss_and_grads(p, jnp.asarray(x), jnp.asarray(y))
    init_opt, step = jtrain.make_train_step(alpha=ALPHA, learning_rate=1e-2)
    jp, _, jloss = jax.jit(step)(_jparams(p), init_opt(_jparams(p)), jnp.asarray(x),
                                 jnp.asarray(y))

    tp = convert.mlp_params_from_jax(p, device="cpu")
    t_init, t_step = ttrain.make_train_step(alpha=ALPHA, learning_rate=1e-2)
    opt = t_init(tp)
    assert isinstance(opt, torch.optim.Adam)
    tp, opt, loss = t_step(tp, opt, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(loss), float(jl), rtol=FWD_REL)
    np.testing.assert_allclose(float(jloss), float(jl), rtol=0)
    pairs = [(t, g, new) for key in ("w", "b") for t, g, new in zip(tp[key], jg[key], jp[key])]
    for t, g, new in pairs:
        g = np.asarray(g)
        live = np.abs(g) >= 1e-6 * np.abs(g).max()
        assert live.mean() > 0.9
        gmax = float(np.abs(g).max())
        assert np.abs(t.grad.numpy() - g)[live].max() <= FWD_REL * gmax
        assert np.abs(t.detach().numpy() - np.asarray(new))[live].max() <= 1e-6


def test_train_step_trajectory_matches_jax():
    p = _mlp_params(9)
    x, y = _np(10, (64, DIMS[0]), (64, DIMS[-1]))
    init_opt, step = jtrain.make_train_step(alpha=ALPHA, learning_rate=1e-2)
    jp, jopt = _jparams(p), init_opt(_jparams(p))
    jstep = jax.jit(step)
    tp = convert.mlp_params_from_jax(p, device="cpu")
    t_init, t_step = ttrain.make_train_step(alpha=ALPHA, learning_rate=1e-2)
    topt = t_init(tp)
    jl, tl = [], []
    for _ in range(20):
        jp, jopt, a = jstep(jp, jopt, jnp.asarray(x), jnp.asarray(y))
        tp, topt, b = t_step(tp, topt, torch.from_numpy(x), torch.from_numpy(y))
        jl.append(float(a))
        tl.append(float(b))
    assert jl[-1] < jl[0] and tl[-1] < tl[0], (jl, tl)
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    flips = sum(int((ttrain.ternarize_ste(t).detach().numpy()
                     != np.asarray(jtrain.ternarize_ste(w))).sum())
                for t, w in zip(tp["w"], jp["w"]))
    print(f"codes that differ after 20 steps: {flips}")


def test_qat_serving_parity():
    """The served packed model computes what the STE forward trains (the
    absmean scale kept), in the port and against JAX's training forward."""
    p = _mlp_params(11, 0.7, 0.05)
    (x,) = _np(12, (8, DIMS[0]))
    want = np.asarray(jtrain.qat_forward(_jparams(p), jnp.asarray(x), ALPHA))
    tp = convert.mlp_params_from_jax(p, device="cpu")
    trained = ttrain.qat_forward(tp, torch.from_numpy(x), ALPHA).detach()
    served = tmlp.mlp_forward(tmlp.pack_mlp(tp, quantize=True), torch.from_numpy(x),
                              tmlp.TernaryMLPConfig(layer_dims=DIMS))
    tol = max(1e-4, 2e-6 * float(trained.abs().max()))
    _close(served, trained.numpy(), tol, "QAT vs packed serving")
    _close(served, want, tol, "port serving vs JAX QAT")


def test_attention_qat_serving_parity():
    jcfg = jattn.TernaryAttentionConfig(d_model=64, n_heads=2)
    tcfg = tattn.TernaryAttentionConfig(d_model=64, n_heads=2)
    params = jattn.init_attention(jax.random.PRNGKey(13), jcfg)
    p = {k: np.asarray(v) * 0.6 + 0.02 for k, v in params.items()}
    (x,) = _np(14, (2, 8, 64))
    want = np.asarray(jattn.qat_attention_forward(_jparams(p), jnp.asarray(x), jcfg))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    trained = tattn.qat_attention_forward(tp, torch.from_numpy(x), tcfg).detach()
    served = tattn.attention_forward(tattn.pack_attention(tp, quantize=True),
                                     torch.from_numpy(x), tcfg, use_kernel=False)
    tol = max(1e-3, 1e-5 * float(trained.abs().max()))
    _close(served, trained.numpy(), tol, "attention QAT vs serving")
    _close(trained, want, FWD_REL * _rel(want), "attention QAT vs JAX")


# ---------------------------------------------------------------- nn


def _dense_pair(seed, in_f, feat, alpha):
    m = jnn.TernaryDense(features=feat, alpha=alpha)
    (x,) = _np(seed, (4, in_f))
    params = m.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    td = tnn.TernaryDense(in_f, feat, alpha=alpha, device="cpu")
    td.load_state_dict(convert.ternary_dense_from_jax(
        jax.tree_util.tree_map(np.asarray, params), device="cpu"))
    return m, params, td, x


def test_ternary_dense_trains_and_matches_jax():
    m, params, td, x = _dense_pair(1, 16, 32, 0.2)
    want = np.asarray(m.apply(params, jnp.asarray(x)))
    y = td(torch.from_numpy(x))
    _close(y, want, FWD_REL * _rel(want), "TernaryDense vs flax")
    (y ** 2).sum().backward()
    grads = [td.kernel.grad, td.bias.grad]
    assert all(torch.isfinite(g).all() for g in grads)
    assert any(float(g.abs().max()) > 0 for g in grads)
    assert td(torch.from_numpy(x).to(torch.bfloat16)).dtype == torch.bfloat16
    # LeCun normal: a normal of std 1/sqrt(in) truncated at two deviations
    k = tnn.TernaryDense(1024, 512, device="cpu", generator=torch.Generator().manual_seed(3))
    assert abs(float(k.kernel.detach().std()) - 1 / 32) < 1e-3
    assert float(k.kernel.abs().max()) <= 2 / 32 / 0.8796256610342398 + 1e-6
    assert float(k.bias.abs().max()) == 0.0


def test_convert_and_serve_matches_qat():
    m, params, td, x = _dense_pair(2, 64, 128, 0.2)
    y_qat = td(torch.from_numpy(x)).detach()
    packed = tnn.convert_to_packed(td.state_dict())
    jpacked = jnn.convert_to_packed(params["params"])
    np.testing.assert_array_equal(packed["packed_kernel"].numpy(),
                                  np.asarray(jpacked["packed_kernel"]))
    np.testing.assert_allclose(float(packed["kernel_scale"]),
                               float(jpacked["kernel_scale"]), rtol=1e-6)
    serve = tnn.PackedTernaryDense(64, 128, alpha=0.2, compute_dtype=torch.float32,
                                   device="cpu")
    serve.load_state_dict(packed)
    _close(serve(torch.from_numpy(x)), y_qat.numpy(), 1e-4, "packed serving vs QAT")


def test_convert_nested_tree():
    _, params, td, _ = _dense_pair(3, 8, 16, None)
    tree = {"layers_0": td.state_dict(), "other": {"stats": torch.ones(3)}}
    out = tnn.convert_to_packed(tree)
    assert set(out["layers_0"]) == {"packed_kernel", "kernel_scale", "bias"}
    np.testing.assert_array_equal(out["other"]["stats"].numpy(), 1.0)
    flat = tnn.convert_to_packed(torch.nn.Sequential(td, td).state_dict())
    assert set(flat) == {"0.packed_kernel", "0.kernel_scale", "0.bias",
                         "1.packed_kernel", "1.kernel_scale", "1.bias"}
    jout = jnn.convert_to_packed({"layers_0": params["params"]})
    np.testing.assert_array_equal(out["layers_0"]["packed_kernel"].numpy(),
                                  np.asarray(jout["layers_0"]["packed_kernel"]))


def test_training_checkpoint_roundtrip(tmp_path):
    """torch.save/torch.load of the masters and the Adam state (the orbax
    round trip's twin) is bitwise, and a step after loading equals the step
    taken in memory."""
    p = _mlp_params(15)
    x, y = _np(16, (16, DIMS[0]), (16, DIMS[-1]))
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    init_opt, step = ttrain.make_train_step(alpha=ALPHA, learning_rate=1e-2)
    tp = convert.mlp_params_from_jax(p, device="cpu")
    opt = init_opt(tp)
    tp, opt, _ = step(tp, opt, x, y)
    path = tmp_path / "ckpt.pt"
    torch.save({"params": tp, "opt": opt.state_dict()}, path)
    back = torch.load(path)
    for a, b in zip(ttrain.param_leaves(tp), ttrain.param_leaves(back["params"])):
        assert torch.equal(a.detach(), b.detach())
    bp = {k: [t.detach().clone() for t in v] for k, v in back["params"].items()}
    bopt = init_opt(bp)
    bopt.load_state_dict(back["opt"])
    for sa, sb in zip(opt.state.values(), bopt.state.values()):
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[name], sb[name])
    tp, opt, la = step(tp, opt, x, y)
    bp, bopt, lb = step(bp, bopt, x, y)
    assert torch.equal(la, lb)
    for a, b in zip(ttrain.param_leaves(tp), ttrain.param_leaves(bp)):
        assert torch.equal(a.detach(), b.detach())
