"""The reduction of the program's spans against the device trace
(``perfbench/lib/spans.py``), and the idle gaps ``trace.summarize`` names
after them."""

from __future__ import annotations

import pytest

from perfbench_tiny_cells import write_root

from perfbench.lib import spans, spec, trace

US = 1e-6


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid,
            "pid": 1, "args": args}


def _launch(ts, corr, name="cudaLaunchKernel", dur=5):
    return _x(name, "cuda_runtime", ts, dur, correlation=corr)


def _op(name, ts, dur, corr, cat="kernel"):
    return _x(name, cat, ts, dur, tid=7, correlation=corr)


def synthetic_events() -> list:
    """A window [1000, 2000] µs: two decode steps, the first with a block's
    attention around the cache read and the head around B1; launch calls
    inside and outside the spans, a call nested in another, an operation
    that starts before its launch call, one whose call is not in the trace,
    one cut by the window's end and one before it."""
    ann = "user_annotation"
    return [
        _x("ProfilerStep#1", ann, 990, 1110),
        _x(trace.SLICE, ann, 1000, 1000),
        _x("lm.decode_step", ann, 500, 100),  # before the window
        _x("lm.decode_step", ann, 1010, 490),
        _x("block.attn", ann, 1020, 180),
        _x("attn.decode[plain]", ann, 1050, 100),
        _x("lm.head", ann, 1300, 100),
        _x("kernel.B1", ann, 1310, 80),
        _x("lm.decode_step", ann, 1510, 80),
        _x("aten::add", "cpu_op", 1031, 2),
        _launch(900, 9),
        _launch(1030, 1),
        _launch(1060, 2),
        _launch(1070, 3, "cudaMemcpyAsync"),
        _launch(1320, 4),
        _x("cuLaunchKernel", "cuda_driver", 1321, 3, correlation=5),  # inside call 4
        _launch(1520, 6, dur=2),
        _launch(1700, 7, dur=2),
        _x("cudaStreamSynchronize", "cuda_runtime", 1800, 150, correlation=10),
        _launch(1980, 8, dur=2),
        _op("k9", 950, 40, 9),
        _op("k1", 1040, 60, 1),
        _op("k2", 1100, 80, 2),
        _op("Memcpy DtoD", 1200, 10, 3, cat="gpu_memcpy"),
        _op("b1", 1318, 32, 4),  # starts 2 µs before its launch call
        _op("k6", 1530, 30, 6),
        _op("k7", 1710, 10, 7),
        _op("Memset", 1960, 10, 99, cat="gpu_memset"),  # its call is not in the trace
        _op("k8", 1990, 20, 8),  # cut at the window's end
    ]


# (count, host µs, launches, self, device µs, self, ops, self, idle µs)
EXPECTED = {
    "lm.decode_step": (2, 570, 5, 1, 212, 30, 5, 1, 180),
    "block.attn": (1, 180, 3, 1, 150, 60, 3, 1, 40),
    "attn.decode[plain]": (1, 100, 2, 2, 90, 90, 2, 2, 20),
    "lm.head": (1, 100, 1, 0, 32, 0, 1, 0, 0),
    "kernel.B1": (1, 80, 1, 1, 32, 32, 1, 1, 108),
    spans.OUTSIDE: (0, 0, 2, 2, 30, 30, 3, 3, 410),
}


def _close(a, b):
    return abs(a - b) <= 1e-9


def test_reduce_hand_written_trace():
    out = spans.reduce(synthetic_events(), 1000.0, 2000.0)
    assert set(out["rows"]) == set(EXPECTED)
    for name, want in EXPECTED.items():
        r = out["rows"][name]
        got = [r[f] for f in spans.FIELDS]
        scale = [1, US, 1, 1, US, US, 1, 1, US]
        assert all(_close(g, w * s) for g, w, s in zip(got, want, scale)), (name, got)
    assert out["skew_us"] == 2.0


def test_every_op_charged_once():
    events = synthetic_events()
    out = spans.reduce(events, 1000.0, 2000.0)
    rows = out["rows"].values()
    summary = trace.summarize(events)
    window_ops = sum(s for s, _ in summary.kernels.values())
    assert _close(sum(r["device_s_self"] for r in rows), window_ops)
    assert sum(r["ops_self"] for r in rows) == sum(n for _, n in summary.kernels.values())
    idle = summary.window_s - summary.busy_s
    assert _close(sum(r["idle_s"] for r in rows), idle)


def test_summary_fields_as_before():
    """``summarize``'s fields for this trace, pinned: the spans name the idle
    gaps that would read "host: Python, no operator" without them."""
    s = trace.summarize(synthetic_events())
    assert _close(s.window_s, 1000 * US) and _close(s.busy_s, 242 * US)
    pinned = {"k1": 60, "k2": 80, "Memcpy DtoD": 10, "b1": 32, "k6": 30, "k7": 10,
              "Memset": 10, "k8": 10}
    assert list(s.kernels) == list(pinned)
    assert all(_close(s.kernels[k][0], us * US) and s.kernels[k][1] == 1
               for k, us in pinned.items())
    assert [(n, round(t / US, 6)) for n, t in s.gaps] == [
        ("cudaStreamSynchronize", 240.0), ("lm.decode_step", 180.0),
        ("host: Python, no operator", 150.0), ("lm.decode_step", 108.0),
        ("block.attn", 40.0), ("block.attn", 20.0), ("cudaLaunchKernel", 20.0)]


def test_window_is_the_slice():
    assert spans.window(synthetic_events()) == (1000.0, 2000.0)
    with pytest.raises(RuntimeError):
        spans.window([e for e in synthetic_events() if e["name"] != trace.SLICE])


@pytest.mark.parametrize("cell,name,per_unit", [("tiny.decode", "lm.decode_step", 1),
                                               ("tiny.mlp", "kernel.B1", 2)])
def test_traced_slice_holds_the_spans(tmp_path, cell, name, per_unit):
    """The traffic's own traced slice on the CPU (the profiler records the
    host only): the program's spans of the measured step, and none of the
    discarded warm-up's."""
    import torch

    manifest = write_root(tmp_path)
    c = spec.load_cell(cell, manifest, tmp_path)
    traffic = spec.traffic_module(c).Traffic(c, 5, torch.device("cpu"))
    summary, _, reduced = spans.traced(traffic)
    rows = reduced["rows"]
    assert rows[name]["count"] == per_unit * c.workload["trace"]["units"]
    assert rows[name]["host_s"] > 0 and rows[spans.OUTSIDE]["device_s"] == 0
    assert summary.window_s > 0 and trace.summarize.__name__ == "summarize"
