"""The system under test for config kind ``ternary_lm``: the port's dense
ternary LM (``smmb_tpu_torch.models.lm``), built from the harness's seeded
masters through the port's ``pack_lm(quantize=True)`` and driven through
its serving entry points ``lm_init_cache``, ``lm_prefill`` and
``lm_decode_step``. The reference is ``perfbench/reference/ternary_lm.py``,
given the configuration and the seed, never the program's weights."""

from __future__ import annotations

import torch

from smmb_tpu_torch.models.lm import (
    TernaryLMConfig,
    lm_decode_step,
    lm_init_cache,
    lm_prefill,
    pack_lm,
)

from perfbench.counts import ternary_lm as counts
from perfbench.inputs import ternary_lm as inputs
from perfbench.lib.device import DTYPES
from perfbench.reference import ternary_lm as reference


class System:
    def __init__(self, cfg: dict, seed: int, dev: torch.device, max_len: int):
        self.cfg, self.seed, self.dev = cfg, seed, dev
        self.lm = TernaryLMConfig(
            vocab=cfg["vocab"], d_model=cfg["d_model"], n_heads=cfg["n_heads"],
            d_ff=cfg["d_ff"], n_layers=cfg["n_layers"], max_len=max_len,
            alpha=cfg["alpha"], non_zero=cfg["non_zero"], eps=cfg["eps"],
            n_kv_heads=cfg["n_kv_heads"], rope=cfg["rope"], rope_theta=cfg["rope_theta"])
        self.cache_dtype = DTYPES[cfg["dtype"]]
        tree = inputs.dense_leaves(cfg, seed, dev, max_len)
        tree["blocks"] = []
        nnz = {kind: [] for kind in counts.KINDS}
        for layer in range(cfg["n_layers"]):
            m = inputs.block_masters(cfg, seed, layer, dev)
            for kind in counts.KINDS:
                nnz[kind].append(torch.count_nonzero(m["attn"].get(kind, m.get(kind))))
            tree["blocks"].append(m)
        tree["head"] = inputs.head_master(cfg, seed, dev)
        nnz["head"] = [torch.count_nonzero(tree["head"])]
        self.packed = pack_lm(tree, quantize=True)
        del tree
        self.nnz = {k: int(torch.stack(v).sum()) for k, v in nnz.items()}

    def prompts(self, tag: str, index: int, batch: int, length: int) -> torch.Tensor:
        return inputs.prompts(self.cfg, self.seed, tag, index, batch, length, self.dev)

    def new_cache(self, batch: int) -> list:
        return lm_init_cache(self.lm, batch, dtype=self.cache_dtype, device=self.dev)

    def prefill(self, tokens, cache, compute_dtype, use_flash):
        return lm_prefill(self.packed, tokens, cache, self.lm, compute_dtype=compute_dtype,
                          use_flash=use_flash)

    def decode(self, tok, cache, compute_dtype, use_flash):
        return lm_decode_step(self.packed, tok, cache, self.lm, compute_dtype=compute_dtype,
                              use_flash=use_flash)

    def free(self) -> None:
        self.packed = None

    def reference_logits(self, groups: list, rounding: str | None = None) -> list:
        return reference.logits(self.cfg, self.seed, groups, self.dev, rounding)
