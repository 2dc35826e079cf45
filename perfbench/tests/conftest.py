"""The harness's tests: the tiny copies of the cells that
``perfbench_tiny_cells.py`` does not know join its ``CELLS`` before any test
module imports it (``perfbench_tiny_routed.register``)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import perfbench_tiny_routed  # noqa: E402

perfbench_tiny_routed.register()
