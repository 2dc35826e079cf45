"""Needed work of the routed ternary LM (config kind ``ternary_moe_lm``) from
its shapes and its routing.

The configuration names its sizes by the published config's keys
(``hidden_size``, ``num_experts``, ``layer_types`` …); ``dims`` reads them
into the port's names. ``nnz`` holds the attention projections' nonzeros
summed over the layers by kind (``wq`` … ``wo``), the head's, and each
expert's up and down nonzeros a layer (``w_up``, ``w_down``: a list of
layers, each a list of experts), counted on the weights the harness drew.

What the result needs, and nothing the program adds:
- each attention projection once at every position (``spmm``), the head at
  the positions whose logits are used (a prefill's last);
- attention over the keys each query attends: the causal half in a full
  layer, ``min(t + 1, window)`` keys at position t in a sliding one
  (``flash``, one item for each kind of layer, summed over its layers);
- each token through its ``top_k`` experts (``experts``): per layer and
  expert, an item of ``m_e`` rows at that expert's nonzeros, up and down,
  X read, the 2-bit W of the experts hit, Y written and the bias read once.
  ``m_e`` are the rows the router sent to expert e, where the traced slice
  recorded them (``routed``); elsewhere each expert's even share,
  N·k / E, whose operations summed over the experts are exact up to the
  spread of the experts' nonzeros (a few in ten thousand).
"""

from __future__ import annotations

from perfbench.counts.ops import Item, ternary_bytes, ternary_item

ATTN_KINDS = ("wq", "wk", "wv", "wo")
EXPERT_KINDS = ("w_up", "w_down")


def dims(cfg: dict) -> dict:
    """The configuration's sizes under the port's names (also the view the
    ternary LM's input helpers read: ``vocab``, ``d_model``, ``max_len``,
    ``non_zero``, ``master_scale``)."""
    win = cfg["sliding_window"]
    return {
        "vocab": cfg["vocab_size"], "d_model": cfg["hidden_size"],
        "n_layers": cfg["num_hidden_layers"], "n_heads": cfg["num_attention_heads"],
        "n_kv_heads": cfg["num_key_value_heads"], "head_dim": cfg["head_dim"],
        "n_experts": cfg["num_experts"], "top_k": cfg["num_experts_per_tok"],
        "d_ff": cfg["moe_intermediate_size"], "eps": cfg["rms_norm_eps"],
        "rope_theta": float(cfg["rope_parameters"]["sliding_attention"]["rope_theta"]),
        "windows": [win if kind == "sliding_attention" else None
                    for kind in cfg["layer_types"]],
        "max_len": cfg["max_len"], "non_zero": cfg["non_zero"],
        "master_scale": cfg["master_scale"], "alpha": cfg["alpha"],
    }


def attn_shapes(dm: dict) -> dict:
    """(K, N) of each attention projection: Q is n_heads·head_dim wide."""
    d, qd = dm["d_model"], dm["n_heads"] * dm["head_dim"]
    kvd = dm["n_kv_heads"] * dm["head_dim"]
    return {"wq": (d, qd), "wk": (d, kvd), "wv": (d, kvd), "wo": (qd, d)}


def expert_shapes(dm: dict) -> dict:
    return {"w_up": (dm["d_model"], dm["d_ff"]), "w_down": (dm["d_ff"], dm["d_model"])}


def attended_pairs(t: int, window: int | None) -> int:
    """(query, key) pairs of a causal prefill of ``t`` tokens: position i
    attends ``min(i + 1, window)`` keys."""
    if window is None or window >= t:
        return t * (t + 1) // 2
    return window * (window + 1) // 2 + (t - window) * window


def attention_items(dm: dict, b: int, t: int, itemsize: int = 2) -> list[Item]:
    """One item a kind of layer (sliding, full), summed over its layers:
    ``4·B·H·hd`` operations a pair, Q, K, V read and O written once."""
    h, kvh, hd = dm["n_heads"], dm["n_kv_heads"], dm["head_dim"]
    one_bytes = b * t * (2 * h + 2 * kvh) * hd * itemsize
    out = []
    for window in sorted(set(dm["windows"]), key=lambda w: (w is None, w)):
        layers = dm["windows"].count(window)
        out.append(Item(layers * 4 * b * h * hd * attended_pairs(t, window),
                        layers * one_bytes))
    return out


def projection_items(dm: dict, nnz: dict, m: int, itemsize: int = 2) -> list[Item]:
    """The attention projections at ``m`` rows, one item a kind (all layers)."""
    layers = dm["n_layers"]
    return [Item(2 * m * nnz[kind] + layers * m * n,
                 layers * ternary_bytes(m, k, n, x_itemsize=itemsize, y_itemsize=itemsize))
            for kind, (k, n) in attn_shapes(dm).items()]


def expert_items(dm: dict, nnz: dict, tokens: int, routed: list | None = None,
                 itemsize: int = 2) -> list[Item]:
    """Each layer's experts, up and down, at ``m_e`` rows: ``routed[layer][e]``
    where given, else the even share ``tokens·top_k / E``."""
    e_count = dm["n_experts"]
    even = tokens * dm["top_k"] / e_count
    items = []
    for layer in range(dm["n_layers"]):
        rows = routed[layer] if routed is not None else [even] * e_count
        for kind, (k, n) in expert_shapes(dm).items():
            for e, m in enumerate(rows):
                if m:
                    items.append(Item(2 * m * nnz[kind][layer][e] + m * n,
                                      ternary_bytes(m, k, n, x_itemsize=itemsize,
                                                    y_itemsize=itemsize)))
    return items


def head_item(dm: dict, nnz: dict, m: int, itemsize: int = 2) -> Item:
    return ternary_item(m, dm["d_model"], dm["vocab"], nnz["head"], itemsize)


def prefill_request(cfg: dict, nnz: dict, b: int, t: int, routed: list | None = None,
                    itemsize: int = 2) -> dict:
    """A prefill of ``b`` prompts of ``t`` tokens that yields the last
    position's logits: the attention projections and the head (``spmm``),
    the attention (``flash``), the routed experts (``experts``) and the
    needed operations of all three (``flops``)."""
    dm = dims(cfg)
    proj = projection_items(dm, nnz, b * t, itemsize) + [head_item(dm, nnz, b, itemsize)]
    attn = attention_items(dm, b, t, itemsize)
    experts = expert_items(dm, nnz, b * t, routed, itemsize)
    return {"spmm": proj, "flash": attn, "experts": experts,
            "flops": sum(i.ops for i in proj + attn + experts)}
