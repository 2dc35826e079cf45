"""The port-owned sharded-serving example (examples/torch_sharded_serving.py)
runs end to end on CPU ranks over gloo at a small size: a 2 × 2 mesh, the
sharded MLP and the ring-overlapped column layer each within 1e-4 of the
unsharded calls (its ``main`` returns 0 only then)."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "examples"))

import torch_sharded_serving  # noqa: E402


def test_sharded_serving_example_cpu(capsys):
    rc = torch_sharded_serving.main(["--cpu", "--ranks", "4", "--dims", "1024,2048,1024,1024",
                                     "--rows", "4"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "mesh {'data': 2, 'model': 2} over CPU ranks (gloo)" in out
    assert "a rank's output (4, 1024)" in out and "a rank's panel (4, 1024)" in out
