"""Port parity: ``capture_trace`` and ``annotate`` of
smmb_tpu_torch.bench.trace, the twins of tests/test_aux.py's
``test_capture_trace`` and ``test_annotate_context``.

On the CPU the profiler records CPU activity only: the trace directory holds
one Chrome trace, ``fn`` ran once outside the session, then the session's
discarded warm-up step and ``n_calls`` calls, and an ``annotate`` region
appears in the trace once a traced call, by name.
"""

import json
import os

import pytest
import torch

from smmb_tpu_torch.bench.trace import WARM_CALLS, annotate, capture_trace
from smmb_tpu_torch.formats.packed import pack_ternary
from smmb_tpu_torch.kernels.packed_spmm import packed_spmm

torch.set_num_threads(2)


def _events(d):
    files = [os.path.join(d, f) for f in os.listdir(d)]
    assert len(files) == 1 and files[0].endswith(".json"), files
    with open(files[0]) as f:
        return json.load(f)["traceEvents"]


@pytest.mark.parametrize("n_calls", [1, 2])
def test_capture_trace(tmp_path, n_calls):
    calls = []

    def f(x):
        calls.append(1)
        return x * 2 + 1

    d = capture_trace(f, torch.ones((64, 64)), trace_dir=str(tmp_path / "trace"),
                      n_calls=n_calls)
    assert d == str(tmp_path / "trace") and os.path.isdir(d)
    assert len(calls) == 1 + WARM_CALLS[0] + n_calls
    assert _events(d), "trace holds no events"


def test_annotate_context(tmp_path):
    with annotate("test-region"):
        pass
    # the region and the B1 wrapper's plain version inside it are traced
    p = pack_ternary(torch.eye(512, 256).numpy(), device="cpu")

    def call(x):
        with annotate("b1"):
            return packed_spmm(x, p, compute_dtype=torch.bfloat16)

    d = capture_trace(call, torch.ones((4, 512)), trace_dir=str(tmp_path / "t"), n_calls=3)
    assert sum(e.get("name") == "b1" for e in _events(d)) == 3
