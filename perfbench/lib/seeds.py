"""Seeds derived from the run's ``--seed``: one stream per named purpose, so
that the same seed gives the same weights and inputs whatever else a run
draws, and any whole number (negative or past 64 bits) is a valid seed."""

from __future__ import annotations

import hashlib


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for ``torch.Generator.manual_seed`` from the run's seed
    and the purpose's tags."""
    text = ":".join([str(int(seed)), *map(str, tags)])
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little") >> 1
