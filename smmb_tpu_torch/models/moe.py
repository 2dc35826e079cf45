"""Ternary mixture-of-experts layer (counterpart of smmb_tpu/models/moe.py).

Switch-style routed MoE whose experts are packed ternary FFNs (up → PReLU →
down, each one B1 call on the expert's token slab) behind a small dense
router. Routing follows JAX exactly:

* top-1 (Switch): the argmax of the softmax gates, combined by the raw gate;
  top-k (GShard/Mixtral): the k largest gates, the lower expert first among
  equal gates (a stable descending sort stands in for ``lax.top_k``),
  renormalized over the k chosen;
* slots inside an expert are claimed in token order, rank-major for top-k
  (every rank-0 choice before any rank-1 choice); an assignment past
  ``capacity`` is dropped and contributes nothing;
* the capacity is ``int(capacity_factor·top_k·n/E)`` rounded up to 8, or,
  under ``no_drop`` (serving), n rounded up to 8, so that no token drops and
  a token's output does not depend on its neighbours in the call.

JAX moves tokens with one-hot einsums at HIGHEST. Here the same assignments
move them by index: a scatter into a static (E, C, D) f32 slab buffer (the
dtype JAX's promotion gives) and a gather back, combined in rank order, so
values move exactly, shapes stay static and nothing syncs with the host.
``route_top1`` and ``route_topk`` return JAX's dense (N, E, C) dispatch and
combine tensors from the same assignments.

The router (``router_logits``, in serving and in training alike) takes f32
operands, forms the products and sums in f64 and rounds once to f32: the
correctly rounded product, within an ulp of JAX's HIGHEST. An f32 product
of a token's row can differ by an ulp between a prefill and a decode step
(cuBLAS picks its f32 kernel by shape), which would move the gates and so
the combine; with the router rounded once, a decode step's row is bitwise
the prefill's, as B1's rows are, and the same masters route a token alike
in training and in serving.

Experts are stacked on a leading axis: ``pack_moe`` gives one
``TernaryPacked`` whose ``data`` is (E, K_pad/4, N), each expert's words
byte-identical to JAX's ``pack_ternary_device`` of that expert
(``expert_plane`` takes one out). Serving (``no_drop``) in bf16 runs the
experts grouped: the N·k assignments' rows sorted into expert order by the
slots ``_assign`` gives (``grouped_layout``), two B1g launches over every
expert's rows, the combine in rank order: 2 launches a call, N·k rows in
place of E·C. Elsewhere ``moe_forward`` loops over all E experts, empty
ones included, as JAX's ``lax.scan`` does: 2·E B1 launches a call. The
mode alone picks the path, so the CPU runs the card's.

Training: ``qat_moe_forward`` (STE-ternarized experts, dense f32 products)
returns the output and the Switch load-balance loss; ``make_moe_train_step``
takes Adam steps on the MSE plus ``aux_weight·aux``.
"""

from __future__ import annotations

import dataclasses

import torch

from smmb_tpu_torch.formats.packed import TernaryPacked, pack_ternary_device
from smmb_tpu_torch.kernels.packed_spmm import grouped_spmm, grouped_spmm_plain, packed_spmm
from smmb_tpu_torch.models.train import absmean_scale, make_adam, qat_linear, ternarize_ste
from smmb_tpu_torch.ops.dense import prelu
from smmb_tpu_torch.ops.spmm import packed_spmm_ref
from smmb_tpu_torch.utils import rng
from smmb_tpu_torch.utils.spans import MOE_COMBINE, MOE_DISPATCH, MOE_ROUTE, span


@dataclasses.dataclass(frozen=True)
class TernaryMoEConfig:
    d_model: int
    d_ff: int  # per-expert hidden width
    n_experts: int
    capacity_factor: float = 1.25
    alpha: float = 0.2
    non_zero: int = 2
    top_k: int = 1  # experts per token (1 = Switch, 2 = Mixtral-style)

    def capacity(self, n_tokens: int) -> int:
        """Per-expert token slots, rounded up to a multiple of 8. Scales
        with ``top_k`` (k assignments per token share the slots)."""
        cap = int(self.capacity_factor * self.top_k * n_tokens / self.n_experts)
        return max(8, -(-cap // 8) * 8)


def _round8(n: int) -> int:
    return max(8, -(-n // 8) * 8)


def init_moe(gen: torch.Generator, cfg: TernaryMoEConfig) -> dict:
    """Dense router + stacked ternary expert masters (E, D, F) / (E, F, D),
    on ``gen``'s device."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    return {
        "router": rng.rand_dense(gen, (d, e)) * (1.0 / d ** 0.5),
        "w_up": torch.stack([rng.rand_ternary(gen, (d, f), non_zero=cfg.non_zero)
                             for _ in range(e)]),
        "b_up": rng.rand_dense(gen, (e, f)) * 0.1,
        "w_down": torch.stack([rng.rand_ternary(gen, (f, d), non_zero=cfg.non_zero)
                               for _ in range(e)]),
        "b_down": rng.rand_dense(gen, (e, d)) * 0.1,
    }


def expert_plane(w: TernaryPacked, e: int) -> TernaryPacked:
    """Expert ``e``'s plane of a stacked ``TernaryPacked`` (a contiguous
    view of its words)."""
    return dataclasses.replace(w, data=w.data[e])


def pack_moe(params: dict, quantize: bool = False) -> dict:
    """Expert masters → stacked 2-bit serving weights; ``quantize``: the
    absmean ternarization and its scale per expert (``pack_block``'s rule)."""

    def pack_stack(ws):
        packs, scales = [], []
        for w in ws:
            if quantize:
                packs.append(pack_ternary_device(ternarize_ste(w)))
                scales.append(absmean_scale(w).to(torch.float32).detach())
            else:
                packs.append(pack_ternary_device(w))
                scales.append(torch.ones((), dtype=torch.float32, device=w.device))
        stacked = TernaryPacked(data=torch.stack([p.data for p in packs]).contiguous(),
                                rows=packs[0].rows, cols=packs[0].cols, nnz=packs[0].nnz)
        return stacked, torch.stack(scales)

    w_up, s_up = pack_stack(params["w_up"])
    w_down, s_down = pack_stack(params["w_down"])
    return {
        "router": params["router"],
        "w_up": w_up, "s_up": s_up, "b_up": params["b_up"],
        "w_down": w_down, "s_down": s_down, "b_down": params["b_down"],
    }


def _onehot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """One-hot of ``idx`` over ``n`` classes, all zero where idx ≥ n (as
    ``jax.nn.one_hot``); a comparison, so nothing syncs with the host."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _assign(router_logits: torch.Tensor, capacity: int, k: int):
    """Each token's k assignments: (expert, slot, kept, weight), each (N, k).

    k = 1 is ``route_top1``: the argmax of the gates, weighted by the raw
    gate. k > 1 is ``route_topk``: the k largest gates (the lower index first
    among equal ones), renormalized; slots are claimed rank-major, the
    counts carried from rank to rank: integer positions from one stable
    sort, exactly the cumulative one-hot counts JAX takes rank by rank (a
    cumulative sum down the tokens runs one thread a column on the card)."""
    n = router_logits.shape[0]
    gates = torch.softmax(router_logits, dim=-1)
    if k == 1:
        top_i = torch.argmax(gates, dim=-1, keepdim=True)
        top_v = torch.gather(gates, 1, top_i)
    else:
        srt = torch.sort(gates, dim=-1, descending=True, stable=True)
        top_v, top_i = srt.values[:, :k], srt.indices[:, :k]
        top_v = top_v / top_v.sum(dim=-1, keepdim=True)
    # an assignment's slot: the assignments before it in rank-major order
    # (every rank-0 choice, token by token, then every rank-1 choice ...)
    # that chose the same expert, its position in a stable sort by expert
    order = top_i.t().reshape(-1)
    experts, at = torch.sort(order, stable=True)
    within = torch.arange(n * k, device=order.device) - torch.searchsorted(experts, experts)
    slot = torch.empty_like(within).scatter_(0, at, within).view(k, n).t()
    return top_i, slot, slot < capacity, top_v


def _dense_route(router_logits: torch.Tensor, capacity: int, k: int):
    expert, slot, keep, weight = _assign(router_logits, capacity, k)
    e = router_logits.shape[1]
    dt = router_logits.dtype
    d_r = (_onehot(expert, e, dt)[..., None] * _onehot(slot, capacity, dt)[..., None, :]
           * keep[..., None, None].to(dt))  # (N, k, E, C)
    return d_r.sum(dim=1), (d_r * weight[..., None, None]).sum(dim=1)


def route_top1(router_logits: torch.Tensor, capacity: int):
    """Top-1 (Switch) dispatch and combine, each (N, E, C): a token's slot
    in its expert is the count of earlier tokens routed there; tokens past
    ``capacity`` are dropped (all-zero rows); combine carries the raw gate."""
    return _dense_route(router_logits, capacity, 1)


def route_topk(router_logits: torch.Tensor, capacity: int, k: int):
    """Top-k (GShard) dispatch and combine, each (N, E, C): the k largest
    gates renormalized over the k; slots claimed rank-major, so lower-rank
    choices survive capacity pressure. At k = 1 the renormalized weight is
    1.0, which is not Switch's raw gate: ``_route`` sends k = 1 to
    ``route_top1``."""
    return _dense_route(router_logits, capacity, k)


def _route(router_logits: torch.Tensor, capacity: int, top_k: int):
    """Config-driven dispatch: Switch top-1 (raw gate) or GShard top-k."""
    if top_k == 1:
        return route_top1(router_logits, capacity)
    return route_topk(router_logits, capacity, top_k)


def load_balance_loss(router_logits: torch.Tensor) -> torch.Tensor:
    """Switch's auxiliary loss ``E · Σ_e f_e · P_e``: f_e the pre-capacity
    fraction of tokens whose argmax logit is e (a constant), P_e the mean
    router probability (differentiable)."""
    e = router_logits.shape[-1]
    probs = torch.softmax(router_logits, dim=-1)
    f = _onehot(torch.argmax(router_logits, dim=-1), e, probs.dtype).mean(dim=0)
    return e * torch.sum(f.detach() * probs.mean(dim=0))


def _dispatch(x: torch.Tensor, expert, slot, keep, e: int, capacity: int) -> torch.Tensor:
    """Tokens into their (E, C, D) f32 slabs: a scatter of exact copies (a
    dropped assignment lands in a spare row that is cut off); empty slots
    stay zero."""
    n, d = x.shape
    k = expert.shape[1]
    spare = e * capacity
    flat = torch.where(keep, expert * capacity + slot, spare).reshape(n * k)
    src = x.to(torch.float32)[:, None, :].expand(n, k, d).reshape(n * k, d)
    buf = torch.zeros((spare + 1, d), dtype=torch.float32, device=x.device)
    return buf.index_copy(0, flat, src)[:spare].reshape(e, capacity, d)


def _combine_rows(rows: torch.Tensor, keep, weight) -> torch.Tensor:
    """(N, k, D) expert rows, one an assignment, weighted and summed in rank
    order (f32; a dropped assignment adds zero)."""
    terms = torch.where(keep[..., None], weight[..., None] * rows.to(torch.float32),
                        torch.zeros((), dtype=torch.float32, device=rows.device))
    y = terms[:, 0]
    for r in range(1, terms.shape[1]):
        y = y + terms[:, r]
    return y


def _combine(y_e: torch.Tensor, expert, slot, keep, weight) -> torch.Tensor:
    """Each token's expert rows gathered back from the (E, C, D) slabs,
    weighted and summed in rank order."""
    e, c, d = y_e.shape
    flat = (expert * c + slot.clamp_max(c - 1)).reshape(-1)
    rows = y_e.reshape(e * c, d).index_select(0, flat).reshape(*expert.shape, d)
    return _combine_rows(rows, keep, weight)


def grouped_layout(expert: torch.Tensor, slot: torch.Tensor, n_experts: int):
    """The grouped layout of N tokens' k assignments (every one kept, as
    under ``no_drop``): assignment (n, r) takes row ``offsets[e] + slot`` of
    an (N·k, D) buffer in expert order, ``offsets`` (E + 1,) the exclusive
    cumsum of the experts' counts. Returns (row (N, k), offsets, the token of
    each row, the expert of each row). Scatters and a cumsum on the device:
    nothing is read back to the host."""
    n, k = expert.shape
    dev = expert.device
    flat_e = expert.reshape(-1)
    counts = torch.zeros(n_experts, dtype=torch.int64, device=dev).index_add_(
        0, flat_e, torch.ones_like(flat_e))
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    row = offsets[expert] + slot
    flat = row.reshape(-1)
    token = torch.empty_like(flat).index_copy_(
        0, flat, torch.arange(n * k, device=dev) // k)
    row_expert = torch.empty_like(flat).index_copy_(0, flat, flat_e)
    return row, offsets, token, row_expert


def qat_moe_forward(params: dict, x: torch.Tensor, cfg: TernaryMoEConfig):
    """Training forward on the masters: STE-ternarized experts (dense f32
    products) around serving's routing at the competitive capacity.
    Returns (y, aux); add ``aux_weight·aux`` to the task loss."""
    n = x.shape[0]
    cap = cfg.capacity(n)
    logits = router_logits(x, params["router"])
    expert, slot, keep, weight = _assign(logits, cap, cfg.top_k)
    x_e = _dispatch(x, expert, slot, keep, cfg.n_experts, cap)
    y_e = torch.stack([
        qat_linear(prelu(qat_linear(x_e[i], params["w_up"][i], params["b_up"][i]), cfg.alpha),
                   params["w_down"][i], params["b_down"][i])
        for i in range(cfg.n_experts)])
    return _combine(y_e, expert, slot, keep, weight), load_balance_loss(logits)


def make_moe_train_step(cfg: TernaryMoEConfig, learning_rate: float = 1e-3,
                        aux_weight: float = 1e-2):
    """(init_opt, train_step) for MSE regression on the routed ternary MoE.

    ``init_opt(params)`` returns the ``torch.optim.Adam`` (optax's defaults)
    over the masters, which it marks as requiring grad; ``train_step(params,
    opt_state, x, y) -> (params, opt_state, loss)`` updates them in place and
    returns the loss before the update."""

    def init_opt(params):
        return make_adam(params, learning_rate)

    def train_step(params, opt_state, x, y):
        opt_state.zero_grad(set_to_none=True)
        pred, aux = qat_moe_forward(params, x, cfg)
        loss = torch.mean((pred - y) ** 2) + aux_weight * aux
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach()

    return init_opt, train_step


def _expert_ffn(x_e, w_up, s_up, b_up, w_down, s_down, b_down, alpha,
                compute_dtype, use_kernel):
    """One expert's packed FFN on its (C, D) token slab: two B1 calls, each
    input scaled in its own dtype first (JAX's ``x_e * s_up``)."""
    if use_kernel:
        h = packed_spmm(x_e * s_up, w_up, b_up, alpha, compute_dtype=compute_dtype)
        return packed_spmm(h * s_down, w_down, b_down, compute_dtype=compute_dtype)
    h = packed_spmm_ref(x_e * s_up, w_up, b_up, alpha, dtype=compute_dtype)
    return packed_spmm_ref(h * s_down, w_down, b_down, dtype=compute_dtype)


def router_logits(x: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """(N, E) f32 logits of the router: exact f32 products summed in
    f64, one rounding to f32, so a row does not depend on N."""
    return (x.to(torch.float32).to(torch.float64)
            @ router.to(torch.float32).to(torch.float64)).to(torch.float32)


def _grouped_forward(packed: dict, x: torch.Tensor, cfg: TernaryMoEConfig, expert, slot,
                     keep, weight, use_kernel) -> torch.Tensor:
    """The experts on N·k rows in expert order, in bf16: dispatch (each
    assignment's row, scaled by its expert's ``s_up`` in f32 and cast
    once), B1g up with PReLU, the ``s_down`` scale, B1g down, and the
    combine of ``_combine_rows``. Row for row the slab path's arithmetic,
    so its output, bit for bit. Where ``moe_forward.routed_offsets`` is a
    list, each call appends its (E + 1,) ``offsets`` there, on the device."""
    bf16 = torch.bfloat16
    with span(MOE_DISPATCH):
        row, offsets, token, row_expert = grouped_layout(expert, slot, cfg.n_experts)
        if moe_forward.routed_offsets is not None:
            moe_forward.routed_offsets.append(offsets)
        xs = x.index_select(0, token).to(torch.float32) * packed["s_up"][row_expert][:, None]
    spmm = grouped_spmm if use_kernel else grouped_spmm_plain
    h = spmm(xs.to(bf16), packed["w_up"], packed["b_up"], offsets, cfg.alpha,
             out_dtype=torch.float32)
    h = h * packed["s_down"][row_expert][:, None]
    y = spmm(h.to(bf16), packed["w_down"], packed["b_down"], offsets, out_dtype=x.dtype)
    with span(MOE_COMBINE):
        rows = y.index_select(0, row.reshape(-1)).reshape(*expert.shape, -1)
        return _combine_rows(rows, keep, weight)


def moe_forward(packed: dict, x: torch.Tensor, cfg: TernaryMoEConfig, *,
                compute_dtype=torch.float32, use_kernel: bool = True,
                no_drop: bool = False) -> torch.Tensor:
    """Routed forward: (N, d_model) → (N, d_model) f32, as JAX's promotion
    gives for f32 and bf16 ``x`` alike (the router and the slabs are f32).

    ``no_drop=True`` is the serving mode: C = N rounded up to 8, so no token
    drops (top-k picks distinct experts, so an expert gets at most one
    assignment a token) and a token's output is the same whatever else is in
    the call, which is what makes decode agree with the prefill. There, in
    bf16, the experts run grouped: the N·k assignments' rows in expert
    order, two B1g launches over all experts, the result the slab path's
    bit for bit. Training, the competitive capacity and the f32 and W2A8
    modes keep the (E, C, D) slabs and a B1 pair an expert, on the CPU as
    on the card."""
    n = x.shape[0]
    cap = _round8(n) if no_drop else cfg.capacity(n)
    with span(MOE_ROUTE):
        logits = router_logits(x, packed["router"])
        expert, slot, keep, weight = _assign(logits, cap, cfg.top_k)
    if no_drop and compute_dtype == torch.bfloat16:
        return _grouped_forward(packed, x, cfg, expert, slot, keep, weight, use_kernel)
    return _slab_forward(packed, x, cfg, expert, slot, keep, weight, cap, compute_dtype,
                         use_kernel)


moe_forward.routed_offsets = None  # a list: each grouped call's offsets go there


def _slab_forward(packed: dict, x: torch.Tensor, cfg: TernaryMoEConfig, expert, slot,
                  keep, weight, cap: int, compute_dtype, use_kernel) -> torch.Tensor:
    """The experts on (E, C, D) f32 slabs: a B1 pair an expert, empty ones
    included, as JAX's ``lax.scan``."""
    x_e = _dispatch(x, expert, slot, keep, cfg.n_experts, cap)
    y_e = torch.stack([
        _expert_ffn(x_e[i], expert_plane(packed["w_up"], i), packed["s_up"][i],
                    packed["b_up"][i], expert_plane(packed["w_down"], i),
                    packed["s_down"][i], packed["b_down"][i], cfg.alpha,
                    compute_dtype, use_kernel)
        for i in range(cfg.n_experts)])
    return _combine(y_e.to(x.dtype), expert, slot, keep, weight)
