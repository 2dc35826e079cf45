"""Port parity: data-parallel LM training
(smmb_tpu_torch.parallel.dp_train) against JAX's single-device and
data-parallel steps — the twins of tests/test_dp_train.py:27,60,90,105.

JAX's masters are carried into the port by convert.py; tokens are numpy
arrays from a seed. The port runs on a gloo world of 8 CPU ranks (meshes
8×1 and 4×2, as JAX's), every case in one world
(tests/torch_parallel_ranks.py). Tolerances are JAX's: losses rtol 1e-5,
gradients atol 1e-5 / rtol 1e-4. JAX's HLO test (:117, a gradient
all-reduce in the compiled step) has no HLO here: its twin counts the
port's collectives, one data-axis all_reduce a step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parallel_ranks as ranks
from smmb_tpu.models.lm import TernaryLMConfig, init_lm, make_lm_train_step, qat_lm_forward
from smmb_tpu_torch.parallel.mesh import run_world

torch.set_num_threads(2)

CFG_KW = dict(vocab=64, d_model=64, n_heads=2, d_ff=128, n_layers=1, max_len=16)
CFG = TernaryLMConfig(**CFG_KW)
PARAMS = jax.tree.map(lambda a: a + 0.01, init_lm(jax.random.PRNGKey(40), CFG))
TOKS = np.random.default_rng(41).integers(0, CFG.vocab, (8, 8)).astype(np.int32)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    path = tmp_path_factory.mktemp("dp")
    torch.save({"params": jax.tree.map(np.asarray, PARAMS), "toks": TOKS, "cfg": CFG_KW},
               path / "inputs.pt")
    return run_world(ranks.suite_dp, 8, backend="gloo", device="cpu", args=(str(path),))[0]


def _jax_losses(n):
    init_opt, step = make_lm_train_step(CFG, learning_rate=1e-2)
    p, o, jstep = PARAMS, init_opt(PARAMS), jax.jit(step)
    out = []
    for _ in range(n):
        p, o, loss = jstep(p, o, jnp.asarray(TOKS))
        out.append(float(loss))
    return out


def test_dp_train_matches_single_device(port):
    losses, local_rows, _ = port["dp_8x1"]
    assert local_rows == 1  # the batch really is split over 8 ranks
    np.testing.assert_allclose(losses, _jax_losses(3), rtol=1e-5)


def test_dp_gradient_is_full_batch_mean(port):
    def loss_fn(p, t):
        logits = qat_lm_forward(p, t, CFG)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1], t[:, 1:]).mean()

    g_ref = jax.jit(jax.grad(loss_fn))(PARAMS, jnp.asarray(TOKS))
    got = port["dp_grads"]
    want = jax.tree.leaves(g_ref)
    assert len(got) == len(want)
    for a, b in zip(want, got):
        np.testing.assert_allclose(np.asarray(a), b, atol=1e-5, rtol=1e-4)


def test_dp_train_on_data_model_mesh(port):
    losses, local_rows, _ = port["dp_4x2"]
    assert local_rows == 2
    assert losses[-1] < losses[0], f"loss did not decrease: {losses}"
    np.testing.assert_allclose(losses, _jax_losses(4), rtol=1e-5)


def test_dp_train_rejects_ragged_batch(port):
    assert port["dp_ragged"] is not None and "divisible" in port["dp_ragged"]


def test_dp_step_all_reduces_once(port):
    """Stand-in for JAX's HLO check: each DP step issues exactly one
    data-axis all_reduce (gradients and loss in one buffer) and nothing
    else."""
    _, _, calls = port["dp_8x1"]
    assert calls == {("all_reduce", "data"): 3}
