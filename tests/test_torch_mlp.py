"""Port parity: the packed MLP serving slice (smmb_tpu_torch.models,
smmb_tpu_torch.nn, smmb_tpu_torch.convert) against smmb_tpu.models.mlp and
smmb_tpu.nn, with the JAX package's weights carried across by convert.py.

Tolerance: 1e-5·max|Y|. Activations grow layer by layer, so an absolute
bound would say nothing; f32 sums in another order differ by ~1e-7 of |Y|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smmb_tpu.models import mlp as jmlp
from smmb_tpu.models import train as jtrain
from smmb_tpu.nn import PackedTernaryDense as JPackedTernaryDense
from smmb_tpu_torch.convert import mlp_params_from_jax, packed_mlp_from_jax
from smmb_tpu_torch.formats.packed import pack_ternary
from smmb_tpu_torch.models import mlp as tmlp
from smmb_tpu_torch.models import train as ttrain
from smmb_tpu_torch.nn import PackedTernaryDense
from smmb_tpu_torch.utils import rng
from smmb_tpu_torch.utils.compare import assert_close

torch.set_num_threads(2)
DIMS = (512, 1024, 512)
BATCH = 8


def _tol(y) -> float:
    return 1e-5 * float(np.abs(np.asarray(y)).max())


def _jax_params(seed=0, perturb=False):
    cfg = jmlp.TernaryMLPConfig(layer_dims=DIMS)
    params = jmlp.init_mlp(jax.random.PRNGKey(seed), cfg)
    if perturb:  # fp32 masters for quantize=True
        rs = np.random.default_rng(seed)
        params = {
            "w": [w * 0.7 + rs.normal(0, 0.05, w.shape).astype(np.float32)
                  for w in params["w"]],
            "b": params["b"],
        }
    params_np = jax.tree_util.tree_map(np.asarray, params)
    x = np.random.default_rng(seed + 1).uniform(-1, 1, (BATCH, DIMS[0]))
    return cfg, params_np, x.astype(np.float32)


def _port(params_np, quantize=False):
    cfg = tmlp.TernaryMLPConfig(layer_dims=DIMS)
    params = mlp_params_from_jax(params_np, device="cpu")
    return cfg, tmlp.pack_mlp(params, quantize=quantize)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_mlp_forward_matches_jax(use_kernel):
    jcfg, params_np, x = _jax_params(0)
    jpacked = jmlp.pack_mlp(jax.tree_util.tree_map(jnp.asarray, params_np))
    want = np.asarray(jmlp.mlp_forward(jpacked, jnp.asarray(x), jcfg,
                                       use_kernel=use_kernel))
    cfg, packed = _port(params_np)
    got = tmlp.mlp_forward(packed, torch.from_numpy(x), cfg, use_kernel=use_kernel)
    assert got.shape == (BATCH, DIMS[-1])
    assert_close(got, want, _tol(want), f"mlp use_kernel={use_kernel}")


@pytest.mark.parametrize("use_kernel", [False, True])
def test_mlp_forward_quantized_matches_jax(use_kernel):
    jcfg, params_np, x = _jax_params(2, perturb=True)
    jpacked = jmlp.pack_mlp(jax.tree_util.tree_map(jnp.asarray, params_np),
                            quantize=True)
    want = np.asarray(jmlp.mlp_forward(jpacked, jnp.asarray(x), jcfg,
                                       use_kernel=use_kernel))
    cfg, packed = _port(params_np, quantize=True)
    for jw, tw in zip(jpacked["w"], packed["w"]):
        np.testing.assert_array_equal(tw.data.numpy(), np.asarray(jw.data))
    for js, ts in zip(jpacked["scale"], packed["scale"]):
        assert float(ts) == pytest.approx(float(js), rel=1e-6)
    got = tmlp.mlp_forward(packed, torch.from_numpy(x), cfg, use_kernel=use_kernel)
    assert_close(got, want, _tol(want), "quantized mlp")


def test_packed_mlp_from_jax_serves_jax_planes():
    jcfg, params_np, x = _jax_params(3)
    jpacked = jmlp.pack_mlp(jax.tree_util.tree_map(jnp.asarray, params_np))
    want = np.asarray(jmlp.mlp_forward(jpacked, jnp.asarray(x), jcfg, use_kernel=False))
    packed = packed_mlp_from_jax(jpacked, device="cpu")
    cfg = tmlp.TernaryMLPConfig(layer_dims=DIMS)
    got = tmlp.mlp_forward(packed, torch.from_numpy(x), cfg)
    assert_close(got, want, _tol(want), "jax-packed planes in the port")


def test_packed_ternary_mlp_module():
    jcfg, params_np, x = _jax_params(4)
    jpacked = jmlp.pack_mlp(jax.tree_util.tree_map(jnp.asarray, params_np))
    want = np.asarray(jmlp.mlp_forward(jpacked, jnp.asarray(x), jcfg, use_kernel=False))
    cfg, packed = _port(params_np)
    module = tmlp.PackedTernaryMLP(packed, cfg)
    tx = torch.from_numpy(x)
    got = module(tx)
    assert_close(got, want, _tol(want), "PackedTernaryMLP")
    assert torch.equal(got, tmlp.mlp_forward(packed, tx, cfg))
    state = module.state_dict()
    assert {"w0", "b0", "s0", "w1", "b1", "s1"} <= set(state)
    assert state["w0"].dtype == torch.int8
    # a module rebuilt from the same planes computes the same function
    clone = tmlp.PackedTernaryMLP(packed, cfg)
    clone.load_state_dict(state)
    assert torch.equal(clone(tx), got)


def test_init_mlp_shapes_and_values():
    cfg = tmlp.TernaryMLPConfig(layer_dims=(64, 128, 32), non_zero=4)
    params = tmlp.init_mlp(rng.make_generator(0, "cpu"), cfg)
    assert [tuple(w.shape) for w in params["w"]] == [(64, 128), (128, 32)]
    assert [tuple(b.shape) for b in params["b"]] == [(128,), (32,)]
    for w in params["w"]:
        assert set(np.unique(w.numpy())) <= {-1.0, 0.0, 1.0}
    packed = tmlp.pack_mlp(params)
    assert [float(s) for s in packed["scale"]] == [1.0, 1.0]
    assert cfg.num_layers == 2


@pytest.mark.parametrize("use_bias,alpha", [(True, 0.2), (False, None)])
def test_packed_ternary_dense_matches_flax(use_bias, alpha):
    rs = np.random.default_rng(5)
    k, n = 300, 256
    w = rs.choice(np.array([-1.0, 0.0, 1.0], np.float32), size=(k, n))
    x = rs.uniform(-1, 1, (2, 3, k)).astype(np.float32)
    b = rs.uniform(-1, 1, (n,)).astype(np.float32)
    data = pack_ternary(w, device="cpu").data
    scale = np.float32(0.37)
    jparams = {"packed_kernel": jnp.asarray(data.numpy()),
               "kernel_scale": jnp.asarray(scale)}
    if use_bias:
        jparams["bias"] = jnp.asarray(b)
    jlayer = JPackedTernaryDense(features=n, in_features=k, use_bias=use_bias,
                                 alpha=alpha, compute_dtype=jnp.float32,
                                 use_kernel=False)
    want = np.asarray(jlayer.apply({"params": jparams}, jnp.asarray(x)))

    layer = PackedTernaryDense(k, n, use_bias=use_bias, alpha=alpha,
                               compute_dtype=torch.float32, device="cpu")
    assert layer.packed_kernel.shape == data.shape
    layer.packed_kernel.copy_(data)
    layer.kernel_scale.fill_(float(scale))
    if use_bias:
        layer.bias.copy_(torch.from_numpy(b))
    else:
        assert layer.bias is None
    got = layer(torch.from_numpy(x))
    assert got.shape == (2, 3, n)
    assert_close(got, want, 1e-5 * max(1.0, float(np.abs(want).max())), "dense")
    layer.use_kernel = False
    assert_close(layer(torch.from_numpy(x)), want, 1e-5 * max(1.0, float(np.abs(want).max())))


def test_ternarize_ste_values_match_jax():
    w = np.random.default_rng(6).normal(0, 1, (32, 48)).astype(np.float32)
    want = np.asarray(jtrain.ternarize_ste(jnp.asarray(w)))
    got = ttrain.ternarize_ste(torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(ttrain.absmean_scale(torch.from_numpy(w))) == pytest.approx(
        float(jtrain.absmean_scale(jnp.asarray(w))), rel=1e-6)


def test_ternarize_ste_straight_through_gradient():
    w = torch.tensor([[0.9, -0.05, -2.0], [0.2, 0.0, 0.4]], requires_grad=True)
    c = torch.tensor([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]])
    (ttrain.ternarize_ste(w) * c).sum().backward()
    assert torch.equal(w.grad, c)
    # same gradient as the JAX custom_vjp
    jg = jax.grad(lambda v: (jtrain.ternarize_ste(v) * jnp.asarray(c.numpy())).sum())(
        jnp.asarray(w.detach().numpy()))
    np.testing.assert_array_equal(w.grad.numpy(), np.asarray(jg))
