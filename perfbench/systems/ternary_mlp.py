"""The system under test for config kind ``ternary_mlp``: the port's packed
ternary MLP (``smmb_tpu_torch.models.mlp``), built from the harness's
seeded weights through ``pack_mlp`` and run by ``mlp_forward``. The
reference is ``perfbench/reference/ternary_mlp.py``."""

from __future__ import annotations

import torch

from smmb_tpu_torch.models.mlp import TernaryMLPConfig, mlp_forward, pack_mlp

from perfbench.inputs import ternary_mlp as inputs
from perfbench.lib.device import DTYPES
from perfbench.reference import ternary_mlp as reference


class System:
    def __init__(self, cfg: dict, seed: int, dev: torch.device):
        self.cfg, self.seed, self.dev = cfg, seed, dev
        self.mlp = TernaryMLPConfig(layer_dims=tuple(cfg["layer_dims"]), alpha=cfg["alpha"],
                                    non_zero=cfg["non_zero"])
        layers = [inputs.layer(cfg, seed, i, dev) for i in range(self.mlp.num_layers)]
        self.nnz = [int(n) for n in torch.stack([torch.count_nonzero(w) for w, _ in layers])]
        self.packed = pack_mlp({"w": [w for w, _ in layers], "b": [b for _, b in layers]})
        del layers

    def inputs(self, count: int, rows: int) -> torch.Tensor:
        return inputs.input_pool(self.cfg, self.seed, self.dev, count, rows,
                                 DTYPES[self.cfg["dtype"]])

    def forward(self, x, compute_dtype):
        return mlp_forward(self.packed, x, self.mlp, compute_dtype=compute_dtype)

    def free(self) -> None:
        self.packed = None

    def reference_outputs(self, x: torch.Tensor) -> torch.Tensor:
        return reference.outputs(self.cfg, self.seed, x, self.dev)
