"""``route_share``: the routing's share of the prefill's device time, in %:
the device seconds of the operations launched inside the spans
``moe.route`` (router logits and assignments), ``moe.dispatch`` (rows into
expert order) and ``moe.combine`` (the weighted sum back), over those
launched inside ``lm.prefill``, from the spans reduction of the traced slice
(``slice_work["spans"]``). Nothing without spans or without a prefill."""

ROUTE_SPANS = ("moe.route", "moe.dispatch", "moe.combine")


def read(ctx):
    reduced = ctx.slice_work.get("spans") if ctx.slice_work else None
    if not reduced:
        return None
    rows = reduced["rows"]
    total = rows.get("lm.prefill", {}).get("device_s", 0.0)
    if total <= 0:
        return None
    return 100.0 * sum(rows.get(name, {}).get("device_s", 0.0) for name in ROUTE_SPANS) / total
