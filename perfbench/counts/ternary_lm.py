"""Needed work of the ternary LM (config kind ``ternary_lm``) from its shapes.

``nnz`` holds each projection kind's nonzero count summed over the layers,
and the head's, counted on the weights the harness drew. Items of one kind
are summed over the layers into one item: every layer of a kind has the
same shapes, and its nonzeros differ by a few in ten thousand, so each layer
is bounded on the same side and the sum of the layers' bounds is the bound
of the sum.

The counts are of what the result needs: the head at the positions whose
logits are used (a prefill's last position), and each projection once,
whatever the program computes twice or more.
"""

from __future__ import annotations

from perfbench.counts.ops import (
    Item,
    decode_attention_flops,
    prefill_attention_item,
    ternary_bytes,
    ternary_item,
)

KINDS = ("wq", "wk", "wv", "wo", "w_up", "w_down")


def shapes(cfg: dict) -> dict:
    """(K, N) of each projection kind."""
    d, ff = cfg["d_model"], cfg["d_ff"]
    kvd = cfg["n_kv_heads"] * (d // cfg["n_heads"])
    return {"wq": (d, d), "wk": (d, kvd), "wv": (d, kvd), "wo": (d, d),
            "w_up": (d, ff), "w_down": (ff, d)}


def projection_items(cfg: dict, nnz: dict, m: int, itemsize: int = 2) -> list[Item]:
    """The blocks' projections at ``m`` rows, one item a kind (all layers)."""
    layers = cfg["n_layers"]
    return [Item(2 * m * nnz[kind] + layers * m * n,
                 layers * ternary_bytes(m, k, n, x_itemsize=itemsize, y_itemsize=itemsize))
            for kind, (k, n) in shapes(cfg).items()]


def head_item(cfg: dict, nnz: dict, m: int, itemsize: int = 2) -> Item:
    return ternary_item(m, cfg["d_model"], cfg["vocab"], nnz["head"], itemsize)


def prefill_request(cfg: dict, nnz: dict, b: int, t: int, itemsize: int = 2) -> dict:
    """A prefill of ``b`` prompts of ``t`` tokens that yields the last
    position's logits: the projection items, the flash-attention items and
    the needed operations."""
    hd = cfg["d_model"] // cfg["n_heads"]
    proj = projection_items(cfg, nnz, b * t, itemsize) + [head_item(cfg, nnz, b, itemsize)]
    one = prefill_attention_item(b, cfg["n_heads"], cfg["n_kv_heads"], hd, t, itemsize)
    attn = [Item(one.ops * cfg["n_layers"], one.bytes * cfg["n_layers"])]
    return {"spmm": proj, "flash": attn, "flops": sum(i.ops for i in proj + attn)}


def decode_step(cfg: dict, nnz: dict, b: int, pos: int, itemsize: int = 2) -> dict:
    """One decode step of ``b`` rows at cache position ``pos`` (each query
    attends ``pos + 1`` keys)."""
    hd = cfg["d_model"] // cfg["n_heads"]
    proj = projection_items(cfg, nnz, b, itemsize) + [head_item(cfg, nnz, b, itemsize)]
    attn = cfg["n_layers"] * decode_attention_flops(b, cfg["n_heads"], hd, pos + 1)
    return {"spmm": proj, "flash": [], "flops": sum(i.ops for i in proj) + attn}
