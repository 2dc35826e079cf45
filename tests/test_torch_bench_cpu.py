"""The port's serving benches as CPU smokes, the twins of
tests/test_bench.py's ``test_decode_bench_cpu_smoke`` and tests/test_aux.py's
``test_mlp_bench_cpu`` at JAX's sizes: on an explicit ``device="cpu"``
``run_decode_bench`` and ``run_mlp_bench`` time the plain versions by the
host's clock (``bench/measure.py::measure_host``) and report no bound.
JAX's MLP case on a (1, 2) mesh has no twin: the port's ``run_mlp_bench``
takes no mesh (the sharded MLP is timed by ``bench/scaling.py``).
"""

import math

import pytest
import torch

from smmb_tpu_torch.bench import decode_bench, mlp_bench

torch.set_num_threads(2)


def test_decode_bench_cpu_smoke():
    # JAX's tiny decode loop; 4 + 3·4 steps fit its max_len of 16
    r = decode_bench.run_decode_bench(layers=1, d_model=64, n_heads=2, d_ff=128, batch=1,
                                      max_len=16, prompt_len=4, reps=2, n0=4, device="cpu")
    assert r.step_s > 0 and r.tokens_per_s > 0
    assert r.prefill_tokens_per_s > 0
    assert math.isnan(r.bound_s) and math.isnan(r.frac_roofline)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_mlp_bench_cpu(use_kernel):
    r = mlp_bench.run_mlp_bench(depth=2, dim=512, batch=8, non_zero=2, reps=2,
                                use_kernel=use_kernel, device="cpu")
    assert r.mean_s > 0 and r.rows_per_s > 0 and r.nnz_per_s > 0
    assert r.label == ("kernel" if use_kernel else "plain")
    assert r.bound_by == "not measured" and math.isnan(r.frac_roofline)


def test_benches_time_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        decode_bench.run_decode_bench(layers=1, d_model=64, n_heads=2, d_ff=128,
                                      max_len=16, prompt_len=4, n0=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        mlp_bench.run_mlp_bench(2, 512, 8, 2, reps=1)
