"""Port parity: the masking and validation cases of tests/test_attention.py
(the causal mask, non-causal attention differing, dim validation, a
block's causality) on smmb_tpu_torch.models.attention and .transformer.

JAX's masters (``init_attention``/``init_block`` at PRNGKey(0), packed by
JAX) are carried into the port by ``convert.packed_lm_from_jax``; x comes
from JAX's keys as numpy. Each property is checked on the port with JAX's
tolerance (attention 1e-5, block 1e-4), through the plain products and
through the wrappers (their plain versions on the CPU), and the port's
outputs are held against JAX's at tests/test_attention.py's serving
tolerance, max(1e-4, 2e-6·max|ref|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smmb_tpu.models import attention as jattn
from smmb_tpu.models import transformer as jtb
from smmb_tpu.utils import rng as jrng
from smmb_tpu_torch import convert
from smmb_tpu_torch.models import attention as tattn
from smmb_tpu_torch.models import transformer as ttb
from smmb_tpu_torch.utils import rng
from smmb_tpu_torch.utils.compare import assert_close

torch.set_num_threads(2)
KEY = jax.random.PRNGKey(0)


def _x(seed, shape):
    return np.array(jrng.rand_dense(jax.random.PRNGKey(seed), shape))


def _vs_jax(got, want, what):
    want = np.asarray(want)
    assert_close(got, want, max(1e-4, 2e-6 * float(np.abs(want).max())), what)


def _attention(causal):
    jcfg = jattn.TernaryAttentionConfig(d_model=64, n_heads=2, causal=causal)
    tcfg = tattn.TernaryAttentionConfig(d_model=64, n_heads=2, causal=causal)
    jp = jattn.pack_attention(jattn.init_attention(KEY, jcfg))
    return jcfg, tcfg, jp, convert.packed_lm_from_jax(jp, device="cpu")


@pytest.mark.parametrize("use_kernel", [False, True])
def test_attention_causal_mask(use_kernel):
    jcfg, tcfg, jp, tp = _attention(True)
    x = _x(2, (1, 8, 64))
    x2 = x.copy()
    x2[0, 5:] = 0.0
    # causal: outputs at position t must not change when the future changes
    y_full = tattn.attention_forward(tp, torch.from_numpy(x), tcfg, use_kernel=use_kernel)
    y_cut = tattn.attention_forward(tp, torch.from_numpy(x2), tcfg, use_kernel=use_kernel)
    np.testing.assert_allclose(y_full[0, :5].numpy(), y_cut[0, :5].numpy(), atol=1e-5)
    _vs_jax(y_full, jattn.attention_forward(jp, jnp.asarray(x), jcfg, use_kernel=False),
            "causal attention vs JAX")
    _vs_jax(y_cut, jattn.attention_forward(jp, jnp.asarray(x2), jcfg, use_kernel=False),
            "causal attention (cut) vs JAX")


@pytest.mark.parametrize("use_kernel", [False, True])
def test_attention_non_causal_differs(use_kernel):
    jcfg, tcfg, jp, tp = _attention(False)
    x = _x(3, (1, 8, 64))
    x2 = x.copy()
    x2[0, 7] = 0.0
    y = tattn.attention_forward(tp, torch.from_numpy(x), tcfg, use_kernel=use_kernel)
    y2 = tattn.attention_forward(tp, torch.from_numpy(x2), tcfg, use_kernel=use_kernel)
    # without causal masking, changing the last position affects earlier rows
    assert float((y[0, 0] - y2[0, 0]).abs().max()) > 0
    _vs_jax(y, jattn.attention_forward(jp, jnp.asarray(x), jcfg, use_kernel=False),
            "non-causal attention vs JAX")
    _vs_jax(y2, jattn.attention_forward(jp, jnp.asarray(x2), jcfg, use_kernel=False),
            "non-causal attention (cut) vs JAX")


@pytest.mark.parametrize("d_model,n_heads,n_kv_heads", [(65, 2, None), (64, 4, 3)])
def test_attention_dim_validation(d_model, n_heads, n_kv_heads):
    jcfg = jattn.TernaryAttentionConfig(d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv_heads)
    tcfg = tattn.TernaryAttentionConfig(d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv_heads)
    with pytest.raises(ValueError):
        jattn.init_attention(KEY, jcfg)
    with pytest.raises(ValueError):
        tattn.init_attention(rng.make_generator(0, "cpu"), tcfg)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_transformer_block_causality(use_kernel):
    jcfg = jtb.TernaryBlockConfig(d_model=64, n_heads=2, d_ff=128, causal=True)
    tcfg = ttb.TernaryBlockConfig(d_model=64, n_heads=2, d_ff=128, causal=True)
    jp = jtb.pack_block(jtb.init_block(KEY, jcfg))
    tp = convert.packed_lm_from_jax(jp, device="cpu")
    x = _x(12, (1, 8, 64))
    x2 = x.copy()
    x2[0, 6:] = 0.0
    y1 = ttb.block_forward(tp, torch.from_numpy(x), tcfg, use_kernel=use_kernel)
    y2 = ttb.block_forward(tp, torch.from_numpy(x2), tcfg, use_kernel=use_kernel)
    np.testing.assert_allclose(y1[0, :6].numpy(), y2[0, :6].numpy(), atol=1e-4)
    _vs_jax(y1, jtb.block_forward(jp, jnp.asarray(x), jcfg, use_kernel=False),
            "causal block vs JAX")
    _vs_jax(y2, jtb.block_forward(jp, jnp.asarray(x2), jcfg, use_kernel=False),
            "causal block (cut) vs JAX")
