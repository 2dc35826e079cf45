"""The LM gradients of one batch against the mean of its two halves' (the
split a 2-rank DP step makes), in both packages: JAX's loss of
``make_lm_train_step`` (``_qat_lm_forward_aux`` and the mean
cross-entropy) under ``jax.grad``, and the port's ``lm_loss`` under
autograd, on the same LeCun-scale masters (JAX's ``init_lm`` with every
projection and the head over sqrt(fan_in)) and tokens.

The reading is the worst leaf's max|mean of the halves − whole| over the
largest |g| of the whole batch. In exact arithmetic it is 0 (the mean of
two equal-size means is the batch mean); in f32 it is the rounding of two
summation orders, amplified by the model. On the CPU a row's products do
not depend on the batch; on the card they do (another GEMM for another M),
which ``jitter`` stands in for: the halves' PReLU inputs moved by
jitter·max|x|, so that values near 0 change side of the kink and their
tokens' share of the up-projection's gradients jumps by (1 − alpha). The
test holds the port's reading to within 10× JAX's (and 1e-6 of max|g| at
least) at a small LM, without and with a jitter.

Run as a script, it prints both packages' readings at the ``lm`` CLI's
widths (4 layers, d_model 1024, 8 heads, d_ff 4096, vocab 8192) on 4 rows
of 128 tokens, the split chip_smoke.py's phase 28 reads on the card,
under jitters of 0, 2^-22 and 2^-20:

    python tests/test_torch_dp_split.py
"""

import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # run as a script

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from smmb_tpu.models import lm as jlm  # noqa: E402
from smmb_tpu_torch import convert  # noqa: E402
from smmb_tpu_torch.models import lm as tlm  # noqa: E402
from smmb_tpu_torch.models.train import param_leaves  # noqa: E402

torch.set_num_threads(2)
SMALL = dict(vocab=256, d_model=128, n_heads=4, d_ff=256, n_layers=2)
LM_WIDTHS = dict(vocab=8192, d_model=1024, n_heads=8, d_ff=4096, n_layers=4)


def _lecun(params):
    """numpy masters with every projection's and the head's master over
    sqrt(fan_in) (chip_smoke.py's ``_lecun``)."""
    def scaled(w):
        return (w / np.float32(math.sqrt(w.shape[-2]))).astype(np.float32)

    for blk in params["blocks"]:
        for name in ("wq", "wk", "wv", "wo"):
            blk["attn"][name] = scaled(blk["attn"][name])
        for name in ("w_up", "w_down"):
            blk[name] = scaled(blk[name])
    params["head"] = scaled(params["head"])
    return params


def _named(tree, prefix=""):
    """(dotted name, numpy array) of every leaf of a dict/list tree."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _named(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _named(v, f"{prefix}{i}.")]
    return [(prefix[:-1], np.asarray(tree))]


def _parted(halves, whole):
    """(worst leaf's max|halves − whole| / largest |whole|, its name)."""
    gmax = max(float(np.abs(g).max()) for _, g in whole)
    errs = [(float(np.abs(a - g).max()) / gmax, name)
            for (name, a), (_, g) in zip(halves, whole)]
    return max(errs)


def _signs(shape):
    """A fixed ±1 pattern of ``shape`` (numpy, the same in both packages)."""
    return np.random.default_rng(0).choice(np.array([-1.0, 1.0], np.float32), size=shape)


def _jittered(prelu, jitter, lib):
    """``prelu`` whose input is moved by ``jitter``·max|x| with a fixed sign
    a value (a constant: the gradient's only change is where the kink
    falls), standing in for the other rounding a row takes on the card."""
    def f(x, alpha):
        if lib == "jax":
            shift = jax.lax.stop_gradient(jnp.abs(x).max()) * jitter * _signs(x.shape)
        else:
            shift = x.detach().abs().max() * jitter * torch.from_numpy(_signs(tuple(x.shape)))
        return prelu(x + shift, alpha)

    return f


def _jax_grads(cfg, params, tokens, jitter=0.0):
    from smmb_tpu.ops import dense as jdense

    def loss(p, t):
        logits, aux = jlm._qat_lm_forward_aux(p, t, cfg)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits[:, :-1], t[:, 1:]).mean()
        return ce + 1e-2 * aux

    out = []
    for i, t in enumerate(tokens):
        prelu = jdense.prelu
        if jitter and i:  # the halves only
            jdense.prelu = _jittered(prelu, jitter, "jax")
        try:
            out.append(_named(jax.jit(jax.grad(loss))(params, jnp.asarray(t))))
        finally:
            jdense.prelu = prelu
    return out


def _port_grads(cfg, params_np, tokens, jitter=0.0):
    from smmb_tpu_torch.models import transformer as ttb

    out = []
    prelu = ttb.prelu
    for i, t in enumerate(tokens):
        if jitter and i:  # the halves only
            ttb.prelu = _jittered(prelu, jitter, "torch")
        params = convert.lm_params_from_jax(params_np, device="cpu")
        leaves = param_leaves(params)
        for q in leaves:
            q.requires_grad_(True)
        try:
            tlm.lm_loss(params, torch.from_numpy(t).long(), cfg).backward()
        finally:
            ttb.prelu = prelu
        out.append(_named(jax.tree_util.tree_map(
            lambda q: np.zeros(q.shape, np.float32) if q.grad is None else q.grad.numpy(),
            params, is_leaf=lambda q: isinstance(q, torch.Tensor))))
    return out


def split_readings(widths, batch=4, seq=128, seed=0, jitter=0.0) -> dict:
    """Both packages' split reading on ``batch`` rows of ``seq`` tokens;
    ``jitter`` > 0 moves the halves' PReLU inputs (``_jittered``)."""
    jcfg = jlm.TernaryLMConfig(**widths, max_len=seq)
    tcfg = tlm.TernaryLMConfig(**widths, max_len=seq)
    params = jax.tree_util.tree_map(np.asarray, jlm.init_lm(jax.random.PRNGKey(seed), jcfg))
    params = _lecun(params)
    toks = np.random.default_rng(seed + 1).integers(0, widths["vocab"], (batch, seq))
    parts = [toks, toks[:batch // 2], toks[batch // 2:]]
    out = {}
    for name, grads in (("jax", _jax_grads(jcfg, params, parts, jitter)),
                        ("port", _port_grads(tcfg, params, parts, jitter))):
        whole, a, b = grads
        mean = [(n, (x + y) / 2) for (n, x), (_, y) in zip(a, b)]
        out[name] = _parted(mean, whole)
    return out


@pytest.mark.parametrize("jitter", [0.0, 2.0 ** -20])
def test_split_reads_as_jax_does(jitter):
    r = split_readings(SMALL, batch=4, seq=32, jitter=jitter)
    (jerr, _), (terr, _) = r["jax"], r["port"]
    assert terr <= max(10 * jerr, 1e-6), r


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    for jitter in (0.0, 2.0 ** -22, 2.0 ** -20):
        r = split_readings(LM_WIDTHS, jitter=jitter)
        for name, (err, leaf) in r.items():
            print(f"jitter {jitter:.3e}, {name}: {err:.3e} of max|g| at {leaf}", flush=True)
    sys.exit(0)
