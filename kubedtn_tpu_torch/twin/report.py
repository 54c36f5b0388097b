"""Sweep reporting: rank scenarios and render the comparison table.

Used by the JAX package's `kdt whatif` CLI (the port has no CLI yet) and by
anything that wants a human-readable answer out of a SweepResult. The
ranking is impact-ordered: scenarios that hurt the network most rank
first — the operator's question is "which of these futures do I need
to worry about", so the sort key is (delivery ratio ascending, p99
latency descending, throughput ascending).

Port of kubedtn_tpu/twin/report.py, unchanged: the same ranks and the
same text for the same SweepResult.
"""

from __future__ import annotations


def _key(name: str, m: dict):
    dr = m.get("delivery_ratio")
    p99 = m.get("p99_us")
    return (
        dr if dr is not None else 2.0,      # unknown ranks after real
        -(p99 if p99 is not None else -1.0),
        m.get("throughput_bps", 0.0),
        name,
    )


def rank_results(result, ranks: dict | None = None) -> list:
    """(name, metrics, rank) triples, worst-impact first. `ranks`
    (name → rank) overrides the local scoring — a daemon-served sweep
    already ranked server-side, and re-deriving here could silently
    disagree if the scoring ever changes on one side only."""
    if ranks is not None:
        rows = sorted(zip(result.names, result.metrics),
                      key=lambda nm: ranks[nm[0]])
        return [(name, m, ranks[name]) for name, m in rows]
    rows = sorted(zip(result.names, result.metrics),
                  key=lambda nm: _key(*nm))
    return [(name, m, i + 1) for i, (name, m) in enumerate(rows)]


def _fmt(v, unit: str = "") -> str:
    if v is None:
        return "-"
    if unit == "us":
        return f"{v / 1000.0:.2f}ms" if v >= 1000 else f"{v:.0f}us"
    if unit == "bps":
        for div, suf in ((1e9, "G"), (1e6, "M"), (1e3, "K")):
            if abs(v) >= div:
                return f"{v / div:.2f}{suf}bit/s"
        return f"{v:.0f}bit/s"
    if unit == "ratio":
        return f"{100.0 * v:.2f}%"
    if isinstance(v, float):
        return f"{v:,.0f}"
    return str(v)


def render_report(result, title: str = "what-if sweep",
                  ranks: dict | None = None) -> str:
    """Fixed-width ranked comparison — the `kdt whatif` output."""
    cols = [
        ("#", lambda n, m, r: str(r)),
        ("scenario", lambda n, m, r: n),
        ("delivery", lambda n, m, r: _fmt(m.get("delivery_ratio"),
                                          "ratio")),
        ("p50", lambda n, m, r: _fmt(m.get("p50_us"), "us")),
        # a censored p99 clamped at the ladder's open top bucket reads
        # ">5000ms", never "=5000ms" (telemetry.percentiles_from_hist)
        ("p99", lambda n, m, r: (">" if m.get("p99_censored") else "")
            + _fmt(m.get("p99_us"), "us")),
        ("throughput", lambda n, m, r: _fmt(m.get("throughput_bps"),
                                            "bps")),
        ("lost", lambda n, m, r: _fmt(
            m.get("dropped_loss", 0.0) + m.get("dropped_queue", 0.0)
            + m.get("dropped_ring", 0.0))),
        ("queue", lambda n, m, r: _fmt(m.get("mean_queue_occupancy"))),
    ]
    ranked = rank_results(result, ranks=ranks)
    table = [[fn(n, m, r) for _h, fn in cols] for n, m, r in ranked]
    widths = [max(len(h), *(len(row[i]) for row in table))
              if table else len(h)
              for i, (h, _fn) in enumerate(cols)]
    lines = [
        f"{title}: {result.replicas} replicas x {result.ticks} ticks "
        f"({result.sim_seconds:g}s virtual) in {result.run_s:.3f}s wall"
        + (f" (+{result.compile_s:.2f}s compile)" if result.compile_s
           else "")
        + f", {result.replicas_steps_per_s:,.0f} replica-steps/s",
        "  ".join(h.ljust(w) for (h, _fn), w in zip(cols, widths)),
    ]
    lines.extend("  ".join(c.ljust(w) for c, w in zip(row, widths))
                 for row in table)
    return "\n".join(lines)
