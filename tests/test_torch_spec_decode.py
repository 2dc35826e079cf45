"""Port parity: speculative decoding (smmb_tpu_torch.models.spec_decode and
bench/spec_bench.py) against smmb_tpu, twinning tests/test_spec_decode.py
and tests/test_flash_decode.py's flash spec test.

The contract: greedy speculative decoding emits the target's own greedy
``generate`` tokens, whatever the draft. Each port output is held equal,
token for token, to the port's ``generate`` and to JAX's
``generate_speculative`` on the same weights (carried across by convert.py)
and the same numpy prompt. Both packages run their plain paths
(``use_kernel=False``) in f32; under ``use_flash`` JAX runs its Pallas
kernels in interpret mode and the port its plain versions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smmb_tpu.models import lm as jlm
from smmb_tpu.models import spec_decode as jsd
from smmb_tpu_torch import convert
from smmb_tpu_torch.models import lm as tlm
from smmb_tpu_torch.models import spec_decode as tsd

torch.set_num_threads(2)
TARGET = dict(vocab=64, d_model=128, n_heads=2, d_ff=256, n_layers=2, max_len=64)
DRAFT = dict(vocab=64, d_model=64, n_heads=2, d_ff=128, n_layers=1, max_len=64)


def _lm(seed, **kw):
    """(JAX config, port config, JAX packed, port packed) of a random LM."""
    jcfg, tcfg = jlm.TernaryLMConfig(**kw), tlm.TernaryLMConfig(**kw)
    jpacked = jlm.pack_lm(jlm.init_lm(jax.random.PRNGKey(seed), jcfg))
    return jcfg, tcfg, jpacked, convert.packed_lm_from_jax(jpacked, device="cpu")


def _prompt(seed, b, t, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, (b, t))


def _spec_both(target, draft, prompt, steps, **kw):
    """(port tokens, JAX tokens) of generate_speculative on one prompt;
    ``target`` and ``draft`` are ``_lm`` tuples."""
    got = tsd.generate_speculative(target[3], draft[3], torch.from_numpy(prompt), target[1],
                                   draft[1], steps, use_kernel=False, **kw)
    want = jsd.generate_speculative(target[2], draft[2], jnp.asarray(prompt), target[0],
                                    draft[0], steps, use_kernel=False, **kw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("k", [1, 3, 4])
def test_spec_matches_target_greedy_and_jax(k):
    target, draft = _lm(10, **TARGET), _lm(11, **DRAFT)
    prompt = _prompt(12, 1, 8)
    got, want = _spec_both(target, draft, prompt, 16, k=k)
    plain = tlm.generate(target[3], torch.from_numpy(prompt), target[1], 16, use_kernel=False)
    np.testing.assert_array_equal(got, plain.numpy())
    np.testing.assert_array_equal(got, want)


def test_spec_self_draft_and_stats():
    target = _lm(20, **TARGET)
    prompt = _prompt(21, 1, 6)
    got, stats = tsd.generate_speculative(target[3], target[3], torch.from_numpy(prompt),
                                          target[1], target[1], 12, k=4, use_kernel=False,
                                          return_stats=True)
    plain = tlm.generate(target[3], torch.from_numpy(prompt), target[1], 12, use_kernel=False)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    want, jstats = jsd.generate_speculative(target[2], target[2], jnp.asarray(prompt),
                                            target[0], target[0], 12, k=4, use_kernel=False,
                                            return_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats["rounds"] == int(jstats["rounds"]) >= 1
    assert stats["mean_accepted"] == pytest.approx(float(jstats["mean_accepted"]))


def test_spec_with_rope_and_gqa():
    target = _lm(30, **{**TARGET, "rope": True, "n_kv_heads": 1})
    draft = _lm(31, **{**DRAFT, "rope": True})
    prompt = _prompt(32, 1, 8)
    got, want = _spec_both(target, draft, prompt, 10, k=3)
    plain = tlm.generate(target[3], torch.from_numpy(prompt), target[1], 10, use_kernel=False)
    np.testing.assert_array_equal(got, plain.numpy())
    np.testing.assert_array_equal(got, want)


def test_spec_guards_as_jax():
    target, draft = _lm(40, **TARGET), _lm(41, **DRAFT)
    with pytest.raises(ValueError, match="max_len"):
        tsd.generate_speculative(target[3], draft[3], torch.zeros((1, 8), dtype=torch.int64),
                                 target[1], draft[1], 60, use_kernel=False)
    small = dict(vocab=32, d_model=128, n_heads=1, d_ff=128, n_layers=1, max_len=48)
    cfg, rcfg = tlm.TernaryLMConfig(**small), tlm.TernaryLMConfig(**small, rope=True)
    toks = torch.zeros((2, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="rope"):
        tsd.generate_speculative(target[3], draft[3], toks, rcfg, cfg, 6, k=2)
    with pytest.raises(ValueError, match="buffer"):
        tsd.generate_speculative(target[3], draft[3], toks, cfg, cfg, 40, k=3)
    with pytest.raises(ValueError, match="vocab"):
        tsd.make_draft_distill_step(target[3], target[1],
                                    tlm.TernaryLMConfig(**{**DRAFT, "vocab": 32}))


def test_batched_spec_matches_plain_rows_jax_and_stats():
    """Batch-4 spec decode (the dead-slot ``valid`` path): every row is the
    target's own greedy continuation of that row, the tokens and the stats
    are JAX's."""
    cfg = dict(vocab=64, d_model=128, n_heads=1, d_ff=128, n_layers=1, max_len=64)
    target, draft = _lm(0, **cfg), _lm(1, **cfg)
    prompt = _prompt(2, 4, 8)
    got, stats = tsd.generate_speculative(target[3], draft[3], torch.from_numpy(prompt),
                                          target[1], draft[1], 8, k=3, use_kernel=False,
                                          return_stats=True)
    assert got.shape == (4, 8)
    for r in range(4):
        alone = tlm.generate(target[3], torch.from_numpy(prompt[r:r + 1]), target[1], 8,
                             use_kernel=False)
        np.testing.assert_array_equal(got[r].numpy(), alone.numpy()[0], err_msg=f"row {r}")
    want, jstats = jsd.generate_speculative(target[2], draft[2], jnp.asarray(prompt),
                                            target[0], draft[0], 8, k=3, use_kernel=False,
                                            return_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats["rounds"] == int(jstats["rounds"]) >= 1
    assert stats["mean_accepted"] == pytest.approx(float(jstats["mean_accepted"]))


def test_clear_dead_marks_each_rows_tail():
    cache = [{"valid": torch.ones((2, 10), dtype=torch.bool), "pos": 7}]
    tsd._clear_dead(cache, 4, torch.tensor([1, 3]), 2)
    assert cache[0]["valid"][:, 4:7].tolist() == [[True, False, False], [True, True, True]]
    assert bool(cache[0]["valid"][:, :4].all()) and bool(cache[0]["valid"][:, 7:].all())
    assert tsd._set_pos(cache, 3)[0]["pos"] == 3 and cache[0]["pos"] == 7


def test_spec_flash_equals_flash_generate_and_jax():
    cfg = dict(vocab=64, d_model=128, n_heads=1, d_ff=128, n_layers=1, max_len=48)
    target, draft = _lm(0, **cfg), _lm(1, **cfg)
    prompt = _prompt(2, 1, 8)
    got, want = _spec_both(target, draft, prompt, 10, k=4, use_flash=True)
    ref = tlm.generate(target[3], torch.from_numpy(prompt), target[1], 10, use_kernel=False,
                       use_flash=True)
    np.testing.assert_array_equal(got, ref.numpy())
    np.testing.assert_array_equal(got, want)


def test_spec_bench_smoke_on_cpu(monkeypatch):
    """The spec bench's three rows at a tiny size, with the card's timer
    replaced by one host-timed call (a CPU run measures no device time)."""
    import time

    from smmb_tpu_torch.bench import spec_bench
    from smmb_tpu_torch.bench.measure import Measurement

    def host_once(fn, *args, reps=1, calls=None):
        t = time.perf_counter()
        fn(*args)
        s = time.perf_counter() - t
        return Measurement(mean_s=s, min_s=s, std_s=0.0, calls_per_batch=1, reps=1)

    monkeypatch.setattr(spec_bench, "measure", host_once)
    tcfg, dcfg = spec_bench.configs(layers=1, d_model=128, n_heads=4, d_ff=256, vocab=64,
                                    draft_d_model=64, draft_d_ff=128, prompt_len=4, steps=3,
                                    k=2)
    assert dataclasses.astuple(dcfg)[:5] == (64, 64, 1, 128, 1)
    assert tcfg.max_len == dcfg.max_len == 4 + 9 + 3
    rows = spec_bench.run_spec_bench(tcfg, dcfg, prompt_len=4, steps=3, k=2, reps=1,
                                     device="cpu")
    assert sorted(rows) == ["plain", "spec-draft", "spec-self"]
    assert rows["spec-self"]["rounds"] >= 1
    assert all(np.isfinite(r["us_per_token"]) for r in rows.values())


def test_cli_spec_mode(monkeypatch):
    import sys

    from smmb_tpu_torch import __main__ as cli
    from smmb_tpu_torch.bench import spec_bench

    seen = []
    monkeypatch.setattr(spec_bench, "main", seen.append)
    monkeypatch.setattr(sys, "argv", ["smmb_tpu_torch", "spec", "--k", "2"])
    cli.main()
    assert seen == [["--k", "2"]]
