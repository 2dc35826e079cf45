"""Format serialization (counterpart of smmb_tpu/io.py).

``save``/``load`` for TCSC, BCSR and TernaryPacked as one ``.npz`` each,
the packed MLP's and the master MLP's save/load, and
``save_pytree``/``load_pytree`` for whole packed models (the LM).

The file layout is JAX's, key for key (``__kind__``, ``__meta_names__``,
``__meta_values__`` and the field arrays; ``w{i}_data``, ``w{i}_meta``,
``b{i}``, ``s{i}``, ``n_layers``; ``__n_leaves__`` and ``leaf{i}``), so a
file saved by either package loads in the other. ``save_pytree`` writes
the leaves in JAX's flatten order: dict keys sorted, lists and tuples in
order, ``None`` holding no leaf, and a packed plane as its int8 ``data``
only (its rows, cols and nnz live in the template's structure).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from smmb_tpu_torch.formats.bcsr import BCSR
from smmb_tpu_torch.formats.packed import TernaryPacked
from smmb_tpu_torch.formats.tcsc import TCSC
from smmb_tpu_torch.formats.tcsc import _host as _np
from smmb_tpu_torch.utils.device import resolve_device

_KIND = {"TCSC": TCSC, "BCSR": BCSR, "TernaryPacked": TernaryPacked}


def save(path: str, obj) -> None:
    """Save a TCSC / BCSR / TernaryPacked matrix to ``path`` (.npz)."""
    kind = type(obj).__name__
    if kind not in _KIND:
        raise TypeError(f"unsupported format: {kind}")
    arrays, meta = {}, {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, (int, float)):
            meta[f.name] = v
        else:
            arrays[f.name] = _np(v)
    np.savez(
        path,
        __kind__=np.array(kind),
        __meta_names__=np.array(list(meta.keys())),
        __meta_values__=np.array([meta[k] for k in meta.keys()]),
        **arrays,
    )


def load(path: str, device=None):
    """Load a matrix saved by ``save``; its arrays land on ``device``
    (None = the CUDA card) with the file's dtypes."""
    dev = resolve_device(device)
    z = np.load(path, allow_pickle=False)
    cls = _KIND[str(z["__kind__"])]
    meta = {}
    for k, v in zip(z["__meta_names__"], z["__meta_values__"]):
        # ints round-trip through the meta array exactly; anything
        # non-integral stays float (never truncate)
        meta[str(k)] = int(v) if float(v) == int(v) else float(v)
    arrays = {k: torch.from_numpy(z[k]).to(dev) for k in z.files if not k.startswith("__")}
    return cls(**arrays, **meta)


def save_packed_mlp(path: str, packed: dict) -> None:
    """Save a ``pack_mlp`` result ({'w': [TernaryPacked...], 'b': [...],
    'scale': [...]})."""
    arrays = {}
    scales = packed.get("scale", [1.0] * len(packed["w"]))
    for i, (w, b, s) in enumerate(zip(packed["w"], packed["b"], scales)):
        arrays[f"w{i}_data"] = _np(w.data)
        arrays[f"w{i}_meta"] = np.array([w.rows, w.cols, w.nnz])
        arrays[f"b{i}"] = _np(b)
        arrays[f"s{i}"] = _np(s).astype(np.float32)
    arrays["n_layers"] = np.array(len(packed["w"]))
    np.savez(path, **arrays)


def load_packed_mlp(path: str, device=None) -> dict:
    """Load a ``save_packed_mlp`` artifact onto ``device`` (None = the card)."""
    dev = resolve_device(device)
    z = np.load(path)
    put = lambda a: torch.from_numpy(np.asarray(a)).to(dev)  # noqa: E731
    out = {"w": [], "b": [], "scale": []}
    for i in range(int(z["n_layers"])):
        rows, cols, nnz = (int(v) for v in z[f"w{i}_meta"])
        out["w"].append(TernaryPacked(data=put(z[f"w{i}_data"]), rows=rows, cols=cols,
                                      nnz=nnz))
        out["b"].append(put(z[f"b{i}"]))
        out["scale"].append(put(z[f"s{i}"]) if f"s{i}" in z.files
                            else torch.ones((), dtype=torch.float32, device=dev))
    return out


def _leaves(tree) -> list:
    """Leaves in JAX's flatten order (see the module docstring)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [v for t in tree for v in _leaves(t)]
    if isinstance(tree, TernaryPacked):
        return [tree.data]
    return [tree]


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves taken in order from ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        new = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(t, leaves) for t in tree)
    if isinstance(tree, TernaryPacked):
        return dataclasses.replace(tree, data=next(leaves))
    return next(leaves)


def save_pytree(path: str, tree) -> None:
    """Save a packed-model tree (dicts, lists, packed planes, tensors) whose
    structure a template re-supplies at load time."""
    leaves = _leaves(tree)
    np.savez(path, __n_leaves__=np.array(len(leaves)),
             **{f"leaf{i}": _np(v) for i, v in enumerate(leaves)})


def load_pytree(path: str, template, device=None):
    """Load a ``save_pytree`` artifact into the structure of ``template``
    (e.g. ``pack_lm(init_lm(gen, cfg))``), leaves on ``device`` (None = the
    card). Leaf count and shapes must match; the template's values are
    discarded."""
    dev = resolve_device(device)
    old = _leaves(template)
    z = np.load(path, allow_pickle=False)
    n = int(z["__n_leaves__"])
    if n != len(old):
        raise ValueError(f"artifact has {n} leaves but template has {len(old)} — "
                         "wrong template structure")
    new = []
    for i, o in enumerate(old):
        arr = z[f"leaf{i}"]
        if tuple(arr.shape) != tuple(np.shape(_np(o))):
            raise ValueError(f"leaf {i}: artifact shape {arr.shape} != template "
                             f"{tuple(np.shape(_np(o)))}")
        new.append(torch.from_numpy(arr).to(dev))
    return _rebuild(template, iter(new))


def save_params(path: str, params: dict) -> None:
    """Save an MLP master-weight tree ({'w': [...], 'b': [...]})."""
    arrays = {}
    for i, (w, b) in enumerate(zip(params["w"], params["b"])):
        arrays[f"w{i}"] = _np(w)
        arrays[f"b{i}"] = _np(b)
    arrays["n_layers"] = np.array(len(params["w"]))
    np.savez(path, **arrays)


def load_params(path: str, device=None) -> dict:
    """Load a ``save_params`` artifact onto ``device`` (None = the card)."""
    dev = resolve_device(device)
    z = np.load(path)
    n = int(z["n_layers"])
    return {
        "w": [torch.from_numpy(z[f"w{i}"]).to(dev) for i in range(n)],
        "b": [torch.from_numpy(z[f"b{i}"]).to(dev) for i in range(n)],
    }
