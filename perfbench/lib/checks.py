"""The numbers that decide ``correct``: each compares what the timed path
produced with the plain reference, and is held against its limit in the
cell's workload file (a number at or under its limit passes)."""

from __future__ import annotations

import torch


def worst_row_error(y: torch.Tensor, ref: torch.Tensor) -> float:
    """max over rows of ``‖y − ref‖ / ‖ref‖``, in f32: one altered or missing
    row reads about 1."""
    y = y.to(torch.float32).reshape(-1, y.shape[-1])
    ref = ref.to(device=y.device, dtype=torch.float32).reshape(-1, ref.shape[-1])
    err = torch.linalg.vector_norm(y - ref, dim=-1)
    return float((err / torch.linalg.vector_norm(ref, dim=-1).clamp_min(1e-30)).max())


def widest_token_gap(ref_logits: torch.Tensor, served: torch.Tensor) -> float:
    """The widest gap by which a served token's reference logit lies below
    the reference's best at its position: ``ref_logits`` (N, V) f32,
    ``served`` (N,) token ids. 0 when every served token is the reference's
    argmax."""
    ref = ref_logits.to(torch.float32).reshape(-1, ref_logits.shape[-1])
    tok = served.to(device=ref.device, dtype=torch.int64).reshape(-1, 1)
    return float((ref.max(dim=-1).values - ref.gather(1, tok)[:, 0]).max())


def control_parts(control: str | None) -> tuple[str | None, str | None]:
    """A cell's control (its workload's ``check.control``) as (the program's
    compute dtype, the reference's rounding dtype): ``program_<dtype>`` runs
    the program on its own lower-precision path, ``reference_<dtype>`` puts
    the reference, rounded to that dtype, in the program's place."""
    if control is None:
        return None, None
    kind, _, dtype = control.partition("_")
    if kind not in ("program", "reference") or not dtype:
        raise ValueError(f"unknown control {control!r}")
    return (dtype, None) if kind == "program" else (None, dtype)


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(all within their limits, {name: {"value", "limit"}}). A number with
    no limit, or one that is not finite, fails."""
    out, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        good = limit is not None and value == value and value <= limit
        ok = ok and good
        out[name] = {"value": value, "limit": limit}
    return ok and bool(numbers), out
