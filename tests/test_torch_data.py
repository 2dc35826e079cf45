"""Port parity: smmb_tpu_torch.runtime.data against smmb_tpu.runtime.data.

The twins of tests/test_data.py: on the same corpus file the port's
``TokenDataset`` yields JAX's batches element for element, with the native
library and with the numpy fallback (each package's ``_lib`` None), and its
batches feed the port's ``make_lm_train_step`` as JAX's feed JAX's: on
each batch the port's loss on JAX's masters is JAX's within one step's
tolerance (tests/test_torch_lm_train.py), and the losses fall.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smmb_tpu.runtime import data as jdata
from smmb_tpu.runtime import native as jnative
from smmb_tpu_torch.runtime import data as tdata
from smmb_tpu_torch.runtime import native as tnative

torch.set_num_threads(2)


@pytest.fixture()
def corpus(tmp_path):
    path = str(tmp_path / "corpus.u32")
    toks = np.arange(1000, dtype=np.int64)  # unique ids: offset == token
    tdata.write_token_file(path, toks)
    return path, toks


@pytest.fixture
def mode(request, monkeypatch):
    """Both packages on their native library, or both on numpy."""
    if not (jnative.native_available() and tnative.native_available()):
        pytest.skip("g++ toolchain unavailable")
    if request.param == "numpy":
        monkeypatch.setattr(jnative, "_lib", lambda: None)
        monkeypatch.setattr(tnative, "_lib", lambda: None)
    return request.param


both_modes = pytest.mark.parametrize("mode", ["native", "numpy"], indirect=True)


def _held(path, epoch=0, **kw) -> np.ndarray:
    """Every batch of the port's dataset, each equal to JAX's, stacked."""
    got = list(tdata.TokenDataset(path, **kw).batches(epoch))
    want = list(jdata.TokenDataset(path, **kw).batches(epoch))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.int64 and g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), w)
    return np.concatenate([g.numpy() for g in got], axis=0)


def test_token_file_matches_jax(corpus, tmp_path):
    path, toks = corpus
    jpath = str(tmp_path / "jax.u32")
    jdata.write_token_file(jpath, toks)
    assert open(path, "rb").read() == open(jpath, "rb").read()


@both_modes
def test_every_window_exactly_once(corpus, mode):
    path, _ = corpus
    ds = tdata.TokenDataset(path, seq_len=9, batch=10)
    assert ds.n_windows == 100 and len(ds) == 10
    got = _held(path, seq_len=9, batch=10)
    assert got.shape == (100, 10)
    for w in got:  # tokens are their own offsets: contiguous spans
        np.testing.assert_array_equal(w, np.arange(w[0], w[0] + 10))
        assert w[0] % 10 == 0
    assert set(int(w[0]) // 10 for w in got) == set(range(100))


@both_modes
def test_deterministic_and_epoch_varies(corpus, mode):
    path, _ = corpus
    a = _held(path, 0, seq_len=9, batch=10, seed=7)
    np.testing.assert_array_equal(a, _held(path, 0, seq_len=9, batch=10, seed=7))
    assert not np.array_equal(a, _held(path, 1, seq_len=9, batch=10, seed=7))


def test_fallback_order_differs_from_native(corpus, monkeypatch):
    """Each mode gives JAX's order in that mode (above); the two modes'
    orders differ from each other, as in JAX."""
    path, _ = corpus
    if not tnative.native_available():
        pytest.skip("g++ toolchain unavailable")
    native = _held(path, seq_len=9, batch=10, seed=3)
    monkeypatch.setattr(jnative, "_lib", lambda: None)
    monkeypatch.setattr(tnative, "_lib", lambda: None)
    fallback = _held(path, seq_len=9, batch=10, seed=3)
    assert fallback.shape == (100, 10) and not np.array_equal(native, fallback)
    assert sorted(fallback[:, 0]) == sorted(native[:, 0])


def test_ragged_tail_dropped_and_too_small_rejected(tmp_path):
    path = str(tmp_path / "tiny.u32")
    tdata.write_token_file(path, np.zeros(25, np.int64))
    ds = tdata.TokenDataset(path, seq_len=9, batch=2)  # 2 windows, 1 batch
    assert ds.n_windows == 2 and len(ds) == 1
    with pytest.raises(ValueError, match="fewer than one batch"):
        tdata.TokenDataset(path, seq_len=9, batch=3)
    with pytest.raises(ValueError, match="1-D"):
        tdata.write_token_file(path, np.zeros((2, 2)))
    with pytest.raises(ValueError, match="int32"):
        tdata.write_token_file(path, np.array([-1, 2]))


def test_feeds_lm_train_step(corpus):
    """Six steps of JAX's train step on JAX's batches; on each, the port's
    step on the port's batch (equal) and JAX's current masters gives JAX's
    loss within 3e-5 relative (one step's tolerance in
    tests/test_torch_lm_train.py). The port's own six steps lower its loss.
    Its trajectory is not held to JAX's: the K bias's gradient is zero in
    exact arithmetic, so Adam moves it by about lr either way on rounding
    noise in each package, and the two trajectories part (2e-3 relative by
    the sixth step here, with no ternary code differing)."""
    from smmb_tpu.models import lm as jlm
    from smmb_tpu_torch import convert
    from smmb_tpu_torch.models import lm as tlm

    path, _ = corpus
    kw = dict(vocab=64, d_model=64, n_heads=2, d_ff=128, n_layers=1, max_len=16)
    masters = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + np.float32(0.01),
        jlm.init_lm(jax.random.PRNGKey(0), jlm.TernaryLMConfig(**kw)))
    jp = jax.tree_util.tree_map(jnp.asarray, masters)
    tp = convert.lm_params_from_jax(masters, device="cpu")
    j_init, j_step = jlm.make_lm_train_step(jlm.TernaryLMConfig(**kw), learning_rate=1e-2)
    t_init, t_step = tlm.make_lm_train_step(tlm.TernaryLMConfig(**kw), learning_rate=1e-2)
    jopt, topt, jstep = j_init(jp), t_init(tp), jax.jit(j_step)
    jl, on_jax, tl = [], [], []
    pairs = zip(jdata.TokenDataset(path, seq_len=11, batch=4).batches(0),
                tdata.TokenDataset(path, seq_len=11, batch=4).batches(0))
    for jb, tb in pairs:
        np.testing.assert_array_equal(tb.numpy(), jb)
        # the corpus's ids are raw offsets: fold them into the vocab
        tb = tb % kw["vocab"]
        here = convert.lm_params_from_jax(
            jax.tree_util.tree_map(np.asarray, jp), device="cpu")
        on_jax.append(float(t_step(here, t_init(here), tb)[2]))
        jp, jopt, a = jstep(jp, jopt, jb % kw["vocab"])
        tp, topt, b = t_step(tp, topt, tb)
        jl.append(float(a))
        tl.append(float(b))
        if len(tl) >= 6:
            break
    np.testing.assert_allclose(on_jax, jl, rtol=3e-5)
    assert jl[-1] < jl[0] and tl[-1] < tl[0], (jl, tl)
