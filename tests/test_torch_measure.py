"""Port parity: smmb_tpu_torch.bench.measure.measure_device, the twin of
tests/test_bench.py::test_measure_device_loop.

JAX's device loop runs on any backend; the port's measurement captures CUDA
graphs, so on the CPU it raises. Its protocol (calibration, the fixed cost
median(2·t_R − t_2R) cancelled, the rotated copies) is held here with the
graph capture and replay replaced by a clock whose replay of R calls takes a
fixed cost plus R times a per-call time.
"""

import importlib

import jax
import jax.numpy as jnp
import pytest
import torch

from smmb_tpu.bench.measure import measure_device as j_measure_device

# the module (the package's ``measure`` name is the function)
tmeasure = importlib.import_module("smmb_tpu_torch.bench.measure")

torch.set_num_threads(2)


def test_measure_device_loop_needs_the_card(monkeypatch):
    f = jax.jit(lambda x: jnp.dot(x, x))
    assert j_measure_device(f, jnp.ones((256, 256)), iters=5, reps=3).mean_s > 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = torch.ones(256, 256)
    with pytest.raises(RuntimeError, match="CUDA card"):
        tmeasure.measure_device(lambda a: a @ a, x, iters=5, reps=3)


@pytest.fixture
def clock(monkeypatch):
    """Graphs as lists of their calls; a replay takes FIXED_S + PER_CALL_S a
    call."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    graphs = []

    def graph(fn, calls):
        graphs.append(calls)
        return calls

    monkeypatch.setattr(tmeasure, "_graph", graph)
    monkeypatch.setattr(tmeasure, "_replay_s", lambda g: 3e-3 + 2e-6 * len(g))
    return graphs


@pytest.mark.parametrize("iters", [None, 100])
def test_measure_device_cancels_the_fixed_cost(clock, iters):
    m = tmeasure.measure_device(lambda a: None, torch.ones(4), iters=iters, reps=4)
    assert m.min_s == pytest.approx(2e-6) and m.mean_s == pytest.approx(2e-6)
    assert m.reps == 4
    if iters is None:  # calibrated: one replay of R calls takes min_batch_s
        assert 3e-3 + 2e-6 * m.calls_per_batch >= tmeasure.MIN_BATCH_S
    else:
        assert m.calls_per_batch == 100
    r = m.calls_per_batch
    assert [len(g) for g in clock[-2:]] == [r, 2 * r]


def test_measure_device_rotates_copies(clock):
    w, x = torch.ones(1000, 250), torch.ones(3)  # 1 MB
    tmeasure.measure_device(lambda a, b: None, x, w, iters=8, reps=2, rotate_argnums=(1,),
                            rotate_min_mb=3.5)
    calls = clock[-1]  # the 2R graph: 16 calls over ceil(3.5 MB / 1 MB) = 4 copies
    ws = [c[1] for c in calls]
    assert len({id(t) for t in ws}) == 4 and ws[0] is w
    assert all(ws[i] is ws[i % 4] and c[0] is x for i, c in enumerate(calls))
    assert all(torch.equal(t, w) for t in ws)
