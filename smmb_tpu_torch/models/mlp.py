"""Ternary MLP — the packed serving path (counterpart of
smmb_tpu/models/mlp.py:39-118).

Each layer is ``Y = PReLU(X·W + B)`` with a ternary W: one ``packed_spmm``
launch per layer (bias and PReLU fused), or, with ``use_kernel=False``, the
plain decode-then-matmul ``packed_spmm_ref``. ``shard_mlp`` and
``mlp_forward_sharded`` (smmb_tpu/models/mlp.py:121-164) run it over the
process mesh of parallel/mesh.py: layers alternate column- and
row-parallel, so the activations stay feature-sharded within a pair.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from smmb_tpu_torch.formats.packed import TernaryPacked, pack_ternary_device
from smmb_tpu_torch.kernels.packed_spmm import packed_spmm
from smmb_tpu_torch.models.train import absmean_scale, ternarize_ste
from smmb_tpu_torch.ops.spmm import packed_spmm_ref
from smmb_tpu_torch.parallel.mesh import MODEL_AXIS, all_gather
from smmb_tpu_torch.parallel.sharded import (
    shard_packed_columns,
    shard_packed_rows,
    sharded_spmm_column,
    sharded_spmm_row,
)
from smmb_tpu_torch.utils import rng


@dataclasses.dataclass(frozen=True)
class TernaryMLPConfig:
    layer_dims: tuple  # (d0, d1, ..., dL): L layers, layer i maps d_i -> d_{i+1}
    alpha: float = 0.2  # PReLU slope
    non_zero: int = 2  # expected density 1/non_zero (reference generator)

    @property
    def num_layers(self) -> int:
        return len(self.layer_dims) - 1


def init_mlp(gen: torch.Generator, cfg: TernaryMLPConfig) -> dict:
    """Random ternary weights + dense biases with the reference's
    distributions, on ``gen``'s device. Weights are dense float ternary
    (the master form); ``pack_mlp`` produces the 2-bit serving form."""
    params = {"w": [], "b": []}
    for i in range(cfg.num_layers):
        d_in, d_out = cfg.layer_dims[i], cfg.layer_dims[i + 1]
        params["w"].append(
            rng.rand_ternary(gen, (d_in, d_out), non_zero=cfg.non_zero)
        )
        params["b"].append(rng.rand_dense(gen, (d_out,)))
    return params


def pack_mlp(params: dict, quantize: bool = False) -> dict:
    """Master weights → packed serving weights.

    quantize=False: masters are already exact ternary matrices, served as
    they are (per-layer scale 1). quantize=True: masters are f32; the served
    weight is ``absmean_scale(w) * ternarize(w)``, with the scalar scale
    kept per layer and folded into the activations at serve time (positive
    scaling commutes with PReLU), keeping the packed planes value-free.
    """
    if quantize:
        terns = [ternarize_ste(w) for w in params["w"]]
        scales = [absmean_scale(w) for w in params["w"]]
    else:
        terns = list(params["w"])
        scales = [
            torch.ones((), dtype=torch.float32, device=w.device)
            for w in params["w"]
        ]
    return {
        "w": [pack_ternary_device(t) for t in terns],
        "b": list(params["b"]),
        "scale": scales,
    }


def _layer_scales(packed: dict):
    # packed dicts from before the quantize-aware format carry no scales
    return packed.get("scale", [None] * len(packed["w"]))


def mlp_forward(
    packed: dict,
    x: torch.Tensor,
    cfg: TernaryMLPConfig,
    *,
    compute_dtype=torch.float32,
    use_kernel: bool = True,
) -> torch.Tensor:
    """Single-device forward through packed layers (PReLU fused per layer)."""
    for w, b, s in zip(packed["w"], packed["b"], _layer_scales(packed)):
        if s is not None:
            x = x * s  # weight scale folded into activations (s > 0)
        if use_kernel:
            x = packed_spmm(x, w, b, alpha=cfg.alpha, compute_dtype=compute_dtype)
        else:
            x = packed_spmm_ref(x, w, b, alpha=cfg.alpha, dtype=compute_dtype)
    return x


def shard_mlp(packed: dict, mesh) -> dict:
    """The rank's shards of the packed layers: even layers column-sharded,
    odd layers row-sharded; biases and scales whole."""
    out = {"w": [], "b": [], "scale": list(_layer_scales(packed))}
    for i, (w, b) in enumerate(zip(packed["w"], packed["b"])):
        shard = shard_packed_columns if i % 2 == 0 else shard_packed_rows
        out["w"].append(shard(w, mesh))
        out["b"].append(b.to(mesh.device))
    out["scale"] = [None if s is None else s.to(mesh.device) for s in out["scale"]]
    return out


def mlp_forward_sharded(
    packed: dict,
    x: torch.Tensor,
    cfg: TernaryMLPConfig,
    *,
    mesh,
    compute_dtype=torch.float32,
    use_kernel: bool = True,
) -> torch.Tensor:
    """Mesh-sharded forward (BASELINE.json config 5) on ``shard_mlp``'s
    shards: x is the rank's batch rows (M_local, d0).

    Even layers column-parallel, odd layers row-parallel: activations stay
    feature-sharded between the pair, and the only collective is the
    model-axis ``all_reduce`` closing each pair; at an odd depth the last
    column layer's panels are gathered, so every rank returns its rows of
    the whole Y (M_local, d_L).
    """
    scales = _layer_scales(packed)
    for i in range(cfg.num_layers):
        w, b = packed["w"][i], packed["b"][i]
        if scales[i] is not None:
            x = x * scales[i]
        layer = sharded_spmm_column if i % 2 == 0 else sharded_spmm_row
        x = layer(x, w, b, mesh=mesh, alpha=cfg.alpha, compute_dtype=compute_dtype,
                  use_kernel=use_kernel)
    if cfg.num_layers % 2 == 1:
        x = all_gather(x, mesh, MODEL_AXIS, dim=-1)
    return x


class PackedTernaryMLP(nn.Module):
    """``mlp_forward`` as a module: the packed int8 planes, the biases and
    the per-layer scales are buffers, so ``.to(device)`` and ``state_dict``
    carry them."""

    def __init__(
        self,
        packed: dict,
        cfg: TernaryMLPConfig,
        *,
        compute_dtype=torch.float32,
    ):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self._meta = [(w.rows, w.cols, w.nnz) for w in packed["w"]]
        layers = zip(packed["w"], packed["b"], _layer_scales(packed))
        for i, (w, b, s) in enumerate(layers):
            self.register_buffer(f"w{i}", w.data)
            self.register_buffer(f"b{i}", b)
            self.register_buffer(f"s{i}", s)

    def packed(self) -> dict:
        n = len(self._meta)
        return {
            "w": [
                TernaryPacked(getattr(self, f"w{i}"), rows, cols, nnz)
                for i, (rows, cols, nnz) in enumerate(self._meta)
            ],
            "b": [getattr(self, f"b{i}") for i in range(n)],
            "scale": [getattr(self, f"s{i}") for i in range(n)],
        }

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_forward(self.packed(), x, self.cfg,
                           compute_dtype=self.compute_dtype)
