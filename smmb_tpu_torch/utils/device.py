"""Device resolution for the port's entry points.

Every entry point takes ``device=None``, which means the CUDA card. Without
one it raises: the port never carries on silently on the CPU. Callers that
want the CPU (the tests) ask for it explicitly.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "smmb_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain versions"
        )
    return dev
