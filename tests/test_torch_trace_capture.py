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


def test_kernel_events_leave_out_annotations():
    """A span around a launch (``utils/spans.py``) is recorded on the device
    as a user annotation, as the session's step is: only kernels count in
    ``kernel_breakdown``, or a spanned kernel's time would count twice."""
    import importlib
    from types import SimpleNamespace as Event

    from torch.autograd import DeviceType

    trace = importlib.import_module("smmb_tpu_torch.bench.trace")
    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    events = [Event(key="packed_spmm_mma_wg", device_type=cuda, self_device_time_total=5.0,
                    is_user_annotation=False),
              Event(key="kernel.B1", device_type=cuda, self_device_time_total=5.0,
                    is_user_annotation=True),
              Event(key="ProfilerStep#2", device_type=cuda, self_device_time_total=9.0,
                    is_user_annotation=True),
              Event(key="aten::mm", device_type=cpu, self_device_time_total=5.0,
                    is_user_annotation=False),
              Event(key="no_time", device_type=cuda, self_device_time_total=0.0,
                    is_user_annotation=False)]
    prof = Event(key_averages=lambda: events)
    assert [e.key for e in trace._kernel_events(prof)] == ["packed_spmm_mma_wg"]
