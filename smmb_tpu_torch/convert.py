"""Carry parameters from the JAX package into the port.

The JAX package's parameters arrive as numpy arrays (``np.asarray`` of each
leaf) or as objects with the fields of a format (``TernaryPacked``,
``TCSC``, ``BCSR``, ``BCSRPrepared``); this module never imports JAX. With
these, both packages compute the same thing on the same arrays, and a
matrix built by either serves in the other (the arrays are identical).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from smmb_tpu_torch.formats.bcsr import BCSR
from smmb_tpu_torch.formats.packed import TernaryPacked
from smmb_tpu_torch.formats.tcsc import TCSC
from smmb_tpu_torch.kernels.bcsr_spmm import BCSRPrepared, col_starts
from smmb_tpu_torch.utils.device import resolve_device


def _tensor(a, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype)


def mlp_params_from_jax(params_np: dict, device=None) -> dict:
    """``{"w": [...], "b": [...]}`` master parameters → the port's, as f32
    tensors on ``device`` (None = the CUDA card)."""
    dev = resolve_device(device)
    return {
        "w": [_tensor(w, dev, torch.float32) for w in params_np["w"]],
        "b": [_tensor(b, dev, torch.float32) for b in params_np["b"]],
    }


def ternary_dense_from_jax(params_np: dict, device=None) -> dict:
    """A flax ``TernaryDense`` parameter tree (``{"params": {"kernel",
    "bias"}}`` or its inner dict) → ``nn.TernaryDense``'s state dict, f32
    tensors on ``device`` (None = the CUDA card)."""
    dev = resolve_device(device)
    inner = params_np.get("params", params_np)
    return {name: _tensor(np.asarray(v), dev, torch.float32) for name, v in inner.items()}


def packed_from_numpy(data, rows: int, cols: int, nnz: int, device=None) -> TernaryPacked:
    """Packed int8 words (e.g. ``np.asarray(p.data)`` of a JAX
    ``TernaryPacked``) → the port's ``TernaryPacked`` on ``device``."""
    dev = resolve_device(device)
    words = _tensor(data, dev, torch.int8)
    if words.dim() != 2 or words.shape[1] != cols:
        raise ValueError(f"packed data {tuple(words.shape)} is not (K_pad/4, {cols})")
    return TernaryPacked(data=words.contiguous(), rows=rows, cols=cols, nnz=nnz)


def packed_mlp_from_jax(packed, device=None) -> dict:
    """A JAX ``pack_mlp`` result → the port's packed MLP dict.

    Each weight needs ``data``, ``rows``, ``cols`` and ``nnz``; biases and
    scales are anything ``np.asarray`` takes. A missing ``scale`` list stays
    missing, as in the JAX format from before quantize-aware packing.
    """
    dev = resolve_device(device)
    out = {
        "w": [
            packed_from_numpy(np.asarray(w.data), w.rows, w.cols, w.nnz, dev)
            for w in packed["w"]
        ],
        "b": [_tensor(np.asarray(b), dev, torch.float32) for b in packed["b"]],
    }
    if "scale" in packed:
        out["scale"] = [
            _tensor(np.asarray(s), dev, torch.float32) for s in packed["scale"]
        ]
    return out


def _tree_from_jax(node, dev):
    """A JAX parameter pytree (dicts, lists, packed planes, arrays) → the
    same tree of the port's tensors and ``TernaryPacked`` planes on ``dev``.
    Float arrays become f32 tensors; packed planes keep their int8 words."""
    if isinstance(node, dict):
        return {k: _tree_from_jax(v, dev) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_tree_from_jax(v, dev) for v in node]
    if all(hasattr(node, f) for f in ("data", "rows", "cols", "nnz")):
        data = np.asarray(node.data)
        if data.ndim == 3:  # MoE experts stacked on a leading axis (pack_moe)
            return TernaryPacked(data=_tensor(data, dev, torch.int8).contiguous(),
                                 rows=int(node.rows), cols=int(node.cols),
                                 nnz=int(node.nnz))
        return packed_from_numpy(data, int(node.rows), int(node.cols), int(node.nnz), dev)
    return _tensor(np.asarray(node), dev, torch.float32)


def lm_params_from_jax(params_np: dict, device=None) -> dict:
    """A JAX ``init_lm`` master pytree (dense or MoE blocks: the router and
    the stacked expert masters too) → the port's, as f32 tensors on
    ``device`` (None = the CUDA card). Also takes ``init_moe`` trees."""
    return _tree_from_jax(params_np, resolve_device(device))


def packed_lm_from_jax(packed, device=None) -> dict:
    """A JAX ``pack_lm`` result → the port's packed LM: the blocks' packed
    planes (``wq``..``wo``, the fused ``wqkv``, ``w_up``, ``w_down``, or an
    MoE block's stacked expert planes, (E, K_pad/4, N)) and the head keep
    their int8 words; scales, biases, norms, routers and embeddings become
    f32 tensors on ``device``. Also takes ``pack_moe`` results."""
    return _tree_from_jax(packed, resolve_device(device))


def _fields(obj, cls, dev, dtypes: dict):
    """The dataclass ``cls`` from ``obj``'s same-named fields: arrays become
    tensors on ``dev`` in ``dtypes[name]``, the rest ints."""
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name in dtypes:
            kw[f.name] = _tensor(np.asarray(getattr(obj, f.name)), dev, dtypes[f.name])
        elif hasattr(obj, f.name):
            kw[f.name] = int(getattr(obj, f.name))
    return kw


def tcsc_from_jax(t, device=None) -> TCSC:
    """A JAX ``TCSC`` (or anything with its fields) → the port's, on
    ``device`` (None = the CUDA card); the index planes stay int32."""
    i32 = torch.int32
    return TCSC(**_fields(t, TCSC, resolve_device(device), {
        "col_start_pos": i32, "col_start_neg": i32,
        "row_index_pos": i32, "row_index_neg": i32}))


def bcsr_from_jax(m, device=None) -> BCSR:
    """A JAX ``BCSR`` → the port's, on ``device`` (f32 block values)."""
    return BCSR(**_fields(m, BCSR, resolve_device(device), {
        "b_row_start": torch.int32, "b_col_idx": torch.int32,
        "b_values": torch.float32}))


def bcsr_prepared_from_jax(p, device=None) -> BCSRPrepared:
    """A JAX ``BCSRPrepared`` → the port's, on ``device``; the port's own
    ``col_start`` is derived from ``blk_col``."""
    dev = resolve_device(device)
    kw = _fields(p, BCSRPrepared, dev, {
        "blk_row": torch.int32, "blk_col": torch.int32, "values": torch.int8,
        "col_has_blocks": torch.float32})
    cs = col_starts(np.asarray(p.blk_col), int(p.k), int(p.cols) // int(p.c))
    return BCSRPrepared(**kw, col_start=_tensor(cs, dev, torch.int32))
