"""Needed work of the packed ternary MLP (config kind ``ternary_mlp``): each
layer one ternary product with its bias (PReLU is not counted, as the
reference benchmark does not count it)."""

from __future__ import annotations

from perfbench.counts.ops import ternary_item


def forward(cfg: dict, nnz: list, rows: int, itemsize: int = 2) -> dict:
    """One forward of ``rows`` rows; ``nnz`` a layer's nonzeros, in order."""
    dims = cfg["layer_dims"]
    items = [ternary_item(rows, dims[i], dims[i + 1], nnz[i], itemsize)
             for i in range(len(dims) - 1)]
    return {"spmm": items, "flash": [], "flops": sum(i.ops for i in items)}
