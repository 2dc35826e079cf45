"""The system under test for config kind ``ternary_moe_lm``: the port's routed
ternary LM (``smmb_tpu_torch.models.lm`` with ``n_experts``), a window a
layer (``layer_windows``) and a head width apart from d_model (``head_dim``),
driven through its serving entry points ``lm_init_cache``, ``lm_prefill``
and ``lm_decode_step``. Each layer's masters are drawn on the card, packed
(``pack_moe_block(quantize=True)``) and dropped before the next layer's, so
f32 masters never exist for more than one layer. The reference is
``perfbench/reference/ternary_moe_lm.py``, given the configuration and the
seed, never the program's weights."""

from __future__ import annotations

import torch

from smmb_tpu_torch.models.lm import (
    TernaryLMConfig,
    lm_decode_step,
    lm_init_cache,
    lm_prefill,
    pack_lm,
)
from smmb_tpu_torch.models.moe_block import pack_moe_block

from perfbench.counts import ternary_moe_lm as counts
from perfbench.inputs import ternary_moe_lm as inputs
from perfbench.lib.device import DTYPES
from perfbench.reference import ternary_moe_lm as reference


class System:
    counts = counts

    def __init__(self, cfg: dict, seed: int, dev: torch.device, max_len: int):
        self.cfg, self.seed, self.dev = cfg, seed, dev
        dm = counts.dims(cfg)
        self.lm = TernaryLMConfig(
            vocab=dm["vocab"], d_model=dm["d_model"], n_heads=dm["n_heads"],
            d_ff=dm["d_ff"], n_layers=dm["n_layers"], max_len=max_len, alpha=dm["alpha"],
            non_zero=dm["non_zero"], eps=dm["eps"], n_kv_heads=dm["n_kv_heads"], rope=True,
            rope_theta=dm["rope_theta"], n_experts=dm["n_experts"], top_k=dm["top_k"],
            head_dim=dm["head_dim"], layer_windows=tuple(dm["windows"]),
            residual_f32=cfg["residual_f32"])
        self.cache_dtype = DTYPES[cfg["dtype"]]
        blocks = []
        nnz = {kind: [] for kind in counts.ATTN_KINDS + counts.EXPERT_KINDS}
        for layer in range(dm["n_layers"]):
            m = inputs.block_masters(cfg, seed, layer, dev)
            for kind in counts.ATTN_KINDS:
                nnz[kind].append(torch.count_nonzero(m["attn"][kind]))
            for kind in counts.EXPERT_KINDS:
                nnz[kind].append(torch.count_nonzero(m["moe"][kind], dim=(1, 2)))
            blocks.append(pack_moe_block(m, quantize=True))
            del m
        tree = inputs.dense_leaves(cfg, seed, dev, max_len)
        tree["blocks"] = []
        tree["head"] = inputs.head_master(cfg, seed, dev)
        nnz["head"] = [torch.count_nonzero(tree["head"])]
        self.packed = pack_lm(tree, quantize=True)
        self.packed["blocks"] = blocks
        del tree
        self.nnz = {k: (torch.stack(v).tolist() if k in counts.EXPERT_KINDS
                        else int(torch.stack(v).sum())) for k, v in nnz.items()}

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
