"""Process environment of a run, set before torch is imported.

Every build and kernel cache the program could write goes to a fixed
directory inside the checkout (``perfbench/.cache/<tool>``), so that only the
first run of a cell in a checkout builds or compiles. The port's own nvcc
libraries already sit at a fixed path inside the checkout
(``smmb_tpu_torch/_build``). Nothing here imports torch.
"""

from __future__ import annotations

import os
from pathlib import Path

CACHE_VARS = {
    "TRITON_CACHE_DIR": "triton",
    "TORCH_EXTENSIONS_DIR": "torch_extensions",
    "TORCHINDUCTOR_CACHE_DIR": "inductor",
    "CUDA_CACHE_PATH": "cuda",
}


def prepare(pkg_dir: Path) -> None:
    """Point the caches into ``pkg_dir/.cache`` and keep JAX out of the
    process (libraries that would load it by themselves are told not to)."""
    cache = pkg_dir / ".cache"
    for var, sub in CACHE_VARS.items():
        path = cache / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
