"""Results reporting: ASCII tables, speedup analysis, CSV, plots
(a copy of smmb_tpu/bench/report.py; the same rows give the same text).

Replaces the reference's three-stage chain (stdout tables and ``key=value``
lines → awk CSV folding → a matplotlib chart): results are structured from
the start (a list of dicts), so the CSV step is direct and the ASCII and
plot renderers consume the same records. Plotting is optional and returns
None without matplotlib.
"""

from __future__ import annotations

import csv
import io
from typing import Iterable


def results_table(rows: list[dict], columns: list[str] | None = None) -> str:
    """Fixed-width ASCII results table (the reference showcase's table,
    minus the box-drawing cosmetics)."""
    if not rows:
        return "(no results)"
    columns = columns or list(rows[0].keys())

    def fmt(v):
        if isinstance(v, float):
            return f"{v:.4g}"
        return str(v)

    widths = {
        c: max(len(c), *(len(fmt(r.get(c, ""))) for r in rows))
        for c in columns
    }
    lines = [
        "  ".join(c.ljust(widths[c]) for c in columns),
        "  ".join("-" * widths[c] for c in columns),
    ]
    for r in rows:
        lines.append(
            "  ".join(fmt(r.get(c, "")).ljust(widths[c]) for c in columns)
        )
    return "\n".join(lines)


def speedup_analysis(rows: list[dict], baseline_kernel: str = "dense") -> str:
    """Speedup-vs-baseline summary (the reference showcase's "PERFORMANCE
    ANALYSIS" block). Expects 'kernel' and 'time_s' or 'mean_s' keys."""
    def t(r):
        return r.get("time_s", r.get("mean_s"))

    base = [r for r in rows if r.get("kernel") == baseline_kernel]
    if not base:
        return "(no baseline row)"
    t0 = t(base[0])
    lines = ["speedup vs " + baseline_kernel + ":"]
    for r in rows:
        if r.get("kernel") == baseline_kernel:
            continue
        lines.append(
            f"  {r['kernel']:<28s} {t0 / t(r):6.2f}x"
        )
    return "\n".join(lines)


def to_csv(rows: Iterable[dict], path: str | None = None) -> str:
    """Rows → CSV string (and optionally a file); no awk folding is needed
    since records are structured."""
    rows = list(rows)
    if not rows:
        return ""
    cols = list(rows[0].keys())
    buf = io.StringIO()
    wtr = csv.DictWriter(buf, fieldnames=cols, extrasaction="ignore")
    wtr.writeheader()
    for r in rows:
        wtr.writerow(r)
    text = buf.getvalue()
    if path:
        with open(path, "w") as f:
            f.write(text)
    return text


def plot_performance(
    rows: list[dict],
    path: str = "performance.png",
    *,
    x_key: str = "case",
    y_key: str = "frac_roofline",
    group_key: str = "kernel",
    title: str = "smmb_tpu sparse ternary SpMM",
    peak: float = 1.0,
):
    """Grouped performance chart → PNG (the reference's performance.py
    chart; the y axis is the fraction of the roofline instead of
    flops/cycle, with the ``peak`` cap line kept). Returns the path, or None
    if matplotlib is unavailable."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return None

    groups: dict[str, list[tuple]] = {}
    any_floor = False
    for r in rows:
        floor = r.get("dispatch_bound", False)
        if isinstance(floor, str):  # CSV round-trip: "True"/"False"
            floor = floor == "True"
        floor = bool(floor)
        any_floor = any_floor or floor
        groups.setdefault(str(r[group_key]), []).append(
            (str(r[x_key]), float(r[y_key]), floor)
        )
    fig, ax = plt.subplots(figsize=(10, 5.5))
    for name, pts in groups.items():
        (line,) = ax.plot(
            [p[0] for p in pts],
            [p[1] for p in pts],
            marker="o",
            label=name,
        )
        # dispatch-floor-dominated rows (< ~10 us): hollow markers — the
        # fraction metric misreads as a loss there even when the kernel
        # wins on absolute time (compare time_s instead)
        fl = [p for p in pts if p[2]]
        if fl:
            ax.plot(
                [p[0] for p in fl], [p[1] for p in fl], ls="none",
                marker="o", mfc="white", mec=line.get_color(), ms=9,
            )
    ax.axhline(peak, color="gray", ls="--", lw=1, label=f"peak = {peak}")
    ax.set_xlabel(x_key)
    ax.set_ylabel(y_key)
    if any_floor:
        title = title + "\n(hollow = dispatch-floor-dominated, <10 µs: compare time, not fraction)"
    ax.set_title(title)
    ax.grid(alpha=0.3)
    ax.legend()
    ax.tick_params(axis="x", rotation=45)
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return path


class Progress:
    """Minimal terminal progress line with ETA (the reference's progress
    bar, without its sleeps)."""

    def __init__(self, total: int, label: str = "", stream=None):
        import sys
        import time

        self.total = max(total, 1)
        self.label = label
        self.n = 0
        self._t0 = time.time()
        self._stream = stream or sys.stderr

    def step(self, k: int = 1):
        import time

        self.n += k
        frac = self.n / self.total
        elapsed = time.time() - self._t0
        eta = elapsed / frac - elapsed if frac > 0 else 0.0
        bar = "#" * int(30 * frac) + "-" * (30 - int(30 * frac))
        self._stream.write(
            f"\r{self.label} [{bar}] {self.n}/{self.total} "
            f"({elapsed:5.1f}s, eta {eta:5.1f}s)"
        )
        if self.n >= self.total:
            self._stream.write("\n")
        self._stream.flush()
