"""Data-parallel QAT training of the ternary LM over the process mesh
(counterpart of smmb_tpu/parallel/dp_train.py).

JAX compiles the single-device step with the batch sharded over ``data``
and lets XLA insert the gradient all-reduce. Here every rank runs the
port's training loss (models/lm.py, ``lm_loss``) on its rows of the batch,
and the step sums the gradients, with the loss riding in the same buffer,
in ONE data-axis ``all_reduce`` and divides by the data-axis size before
the Adam step. The masters and the Adam state stay replicated: every rank
applies the same averaged gradients to the same masters. The loss is a
per-token mean, so the mean of the ranks' equal-size means is the batch's.

On a ``data × model`` mesh the batch shards over ``data`` and is
replicated over ``model``, whose ranks compute the same step.
"""

from __future__ import annotations

import torch

from smmb_tpu_torch.models.lm import TernaryLMConfig, lm_loss
from smmb_tpu_torch.models.train import make_adam, param_leaves
from smmb_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, all_reduce, local_rows


def make_lm_train_step_dp(cfg: TernaryLMConfig, mesh: Mesh, learning_rate: float = 1e-3):
    """Data-parallel (init_opt, train_step, place) for the ternary LM.

    ``place(params, opt_state, tokens)`` takes the global (B, T) batch (B
    divisible by the data-axis size; a ragged batch raises) and returns the
    masters and the optimizer as they are (made on the mesh's device, the
    same on every rank) and the rank's rows of the batch.
    ``train_step(params, opt_state, tokens) -> (params, opt_state, loss)``
    takes those rows, updates the masters in place and returns the whole
    batch's loss before the update, the same on every rank.
    """
    dsz = mesh.axis_size(DATA_AXIS)

    def init_opt(params):
        return make_adam(params, learning_rate)

    def train_step(params, opt_state, tokens):
        opt_state.zero_grad(set_to_none=True)
        loss = lm_loss(params, tokens.long(), cfg)
        loss.backward()
        leaves = param_leaves(params)
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in leaves]
        flat = torch.cat([g.reshape(-1) for g in grads] + [loss.detach().reshape(1)])
        flat = all_reduce(flat, mesh, DATA_AXIS) / dsz
        off = 0
        for p in leaves:
            n = p.numel()
            p.grad = flat[off:off + n].view_as(p).clone()
            off += n
        opt_state.step()
        return params, opt_state, flat[-1]

    def place(params, opt_state, tokens):
        if tokens.shape[0] % dsz:
            raise ValueError(f"batch {tokens.shape[0]} not divisible by data axis {dsz}")
        return params, opt_state, local_rows(tokens, mesh).to(mesh.device)

    return init_opt, train_step, place
