"""Run configuration layer (a copy of smmb_tpu/utils/config.py).

The reference's knobs are compile-time macros and hard-coded workload
vectors. Here a config object enumerates kernels × sizes × sparsities ×
mesh shapes, with a JSON round trip so benchmark runs are reproducible
artifacts. ``to_json`` gives the JAX package's text for the same fields, so
a config written by either package drives the other's benchmarks.
"""

from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    """One benchmark run specification."""

    # workload grid (the reference's SparseGEMM.cpp sweep)
    ms: tuple = (1, 16, 64)
    ks: tuple = (256, 512, 1024)
    ns: tuple = (512, 1024, 2048)
    non_zeros: tuple = (2, 8, 16)  # density = 1/nz
    # kernels to include (names from bench.sweep's registry)
    kernels: tuple = ()  # empty = all available
    # measurement protocol; iters=None lets bench.measure calibrate the
    # calls per timed batch
    iters: int | None = None
    reps: int = 5
    # PReLU slope; None = the benchmark's default (showcase 0.2, sweep 0.25)
    alpha: float | None = None
    seed: int = 0
    # mesh shapes for scaling runs: tuples of (data, model)
    mesh_shapes: tuple = ((1, 1), (1, 2), (1, 4), (1, 8))
    validate: bool = True

    def cases(self):
        import itertools

        return list(
            itertools.product(self.non_zeros, self.ms, self.ks, self.ns)
        )

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "BenchConfig":
        d = json.loads(text)
        for k in ("ms", "ks", "ns", "non_zeros", "kernels"):
            if k in d:
                d[k] = tuple(d[k])
        if "mesh_shapes" in d:
            d["mesh_shapes"] = tuple(tuple(t) for t in d["mesh_shapes"])
        return cls(**d)
