"""Censored-tail estimation — quantiles PAST the bucket ladder's edge.

Port of kubedtn_tpu/slo/tail.py (numpy float64, unchanged).

The telemetry plane's per-edge histograms share one finite bucket
ladder (telemetry.BUCKET_EDGES_US, the reference daemon's
request-duration ladder scaled to µs) whose top bucket is OPEN: every
delivery slower than the last edge lands in it, indistinguishably.
`telemetry.percentiles_from_hist` therefore CLAMPS a quantile whose
target mass falls in that bucket — a p99.9 of 8 seconds reads as
"5000ms", silently understating the tail by the exact amount an SLO
exists to catch.

This module implements the estimation approach of "Scalable Tail
Latency Estimation for Data Center Networks" (PAPERS.md, arxiv
2205.01234): datacenter latency tails are near log-linear over the
upper deciles — the survival function S(x) = P(latency > x) decays
(approximately) exponentially — so the per-bucket survival points the
histogram ALREADY gives us at each edge can be fit with a weighted
least-squares line in (x, ln S(x)) space and extrapolated:

    ln S(x) ≈ a + b·x  (b < 0)   ⇒   x_q = (ln(1 - q) - a) / b

The fit uses only the upper buckets (the tail region the model is
about), weights each point by the mass that crossed its edge (sparse
tail points carry less evidence), and REFUSES rather than guesses:
fewer than `min_points` usable survival points, a non-decaying slope,
or a fit whose extrapolation lands below the last edge all fall back
to the honest censored clamp — flagged as such, never silently.

Quantiles that land INSIDE the ladder use the exact same linear
in-bin interpolation as `percentiles_from_hist` (one implementation
contract: the SLO plane and the telemetry surface cannot disagree
below the edge).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from kubedtn_tpu_torch.telemetry import (BUCKET_EDGES_US,
                                         percentiles_from_hist,
                                         quantile_label)

# estimation method tags (SloVerdict.tail_method, the wire's
# SloTenant.tail_method): how the reported quantile was obtained
METHOD_INTERP = "interp"          # inside the ladder, exact interpolation
METHOD_TAIL_FIT = "tail-fit"      # extrapolated past the edge via the fit
METHOD_CENSORED = "censored-clamp"  # fit refused; clamped + flagged
METHOD_EMPTY = "empty"            # no mass at all

# the fit region: at most this many survival points, taken from the TOP
# of the ladder downward (the log-linear model is a TAIL model — mixing
# in body buckets would tilt the slope toward the body's distribution)
_FIT_POINTS = 5
# extrapolation sanity cap: an estimate beyond this multiple of the
# last edge says the fit ran off a near-flat slope — refuse instead
_MAX_EXTRAPOLATION = 64.0


@dataclasses.dataclass(frozen=True)
class TailFit:
    """One fitted log-linear tail: ln S(x) = intercept + slope·x."""

    intercept: float
    slope: float          # < 0 (decaying survival)
    points: int           # survival points the fit used
    r2: float             # weighted fit quality (1.0 = perfect line)

    def survival(self, x_us: float) -> float:
        return math.exp(self.intercept + self.slope * float(x_us))

    def quantile(self, q: float) -> float:
        """x with S(x) = 1 - q (the fitted quantile)."""
        return (math.log(1.0 - q) - self.intercept) / self.slope


def fit_tail(hist_row: np.ndarray, edges=BUCKET_EDGES_US,
             min_points: int = 3) -> TailFit | None:
    """Fit the upper buckets' log-survival line. None when the
    histogram gives fewer than `min_points` strictly-positive survival
    points in the fit region, or the fitted slope does not decay."""
    h = np.asarray(hist_row, np.float64)
    total = float(h.sum())
    if total <= 0.0:
        return None
    e = np.asarray(edges, np.float64)
    # survival AT each edge: the mass strictly past it
    surv = (total - np.cumsum(h)[:len(e)]) / total
    usable = np.flatnonzero(surv > 0.0)
    if usable.size < min_points:
        return None
    pick = usable[-min(_FIT_POINTS, usable.size):]
    x = e[pick]
    y = np.log(surv[pick])
    # weight by the mass past each edge: a survival point carried by
    # 3 samples should not steer the line like one carried by 3000
    w = surv[pick] * total
    wsum = float(w.sum())
    xm = float((w * x).sum() / wsum)
    ym = float((w * y).sum() / wsum)
    sxx = float((w * (x - xm) ** 2).sum())
    if sxx <= 0.0:
        return None
    slope = float((w * (x - xm) * (y - ym)).sum() / sxx)
    if slope >= 0.0 or not math.isfinite(slope):
        return None  # a non-decaying "tail" is not a tail
    intercept = ym - slope * xm
    syy = float((w * (y - ym) ** 2).sum())
    r2 = 1.0 if syy <= 0.0 else min(
        1.0, max(0.0, (slope * slope * sxx) / syy))
    return TailFit(intercept=intercept, slope=slope,
                   points=int(pick.size), r2=r2)


def estimate_quantile(hist_row: np.ndarray, q: float,
                      edges=BUCKET_EDGES_US,
                      min_points: int = 3) -> tuple[float | None, str]:
    """(value_us, method) for one quantile of a ladder histogram.

    Inside the ladder: exact in-bin interpolation (bit-identical to
    `percentiles_from_hist`, whose implementation is reused). Past the
    edge: the log-linear tail fit when it succeeds (`method`
    "tail-fit", value strictly beyond the last edge), else the honest
    clamp (`method` "censored-clamp"). Empty histogram → (None,
    "empty")."""
    h = np.asarray(hist_row, np.float64)
    total = float(h.sum())
    if total <= 0.0:
        return None, METHOD_EMPTY
    stem = quantile_label(q)
    p = percentiles_from_hist(h, qs=(q,))
    val = p[f"{stem}_us"]
    if not p[f"{stem}_censored"]:
        return val, METHOD_INTERP
    last_edge = float(np.asarray(edges)[-1])
    fit = fit_tail(h, edges=edges, min_points=min_points)
    if fit is not None:
        est = fit.quantile(q)
        if (math.isfinite(est) and last_edge < est
                <= last_edge * _MAX_EXTRAPOLATION):
            return round(est, 3), METHOD_TAIL_FIT
    return last_edge, METHOD_CENSORED


def fraction_slower_than(hist_row: np.ndarray, bound_us: float,
                         edges=BUCKET_EDGES_US) -> float:
    """P(latency > bound) from the ladder histogram — the latency
    objective's error fraction (an SLO "p99 ≤ X" means at most 1% of
    deliveries slower than X). In-ladder bounds interpolate inside
    their bucket; a bound past the last edge uses the tail fit when
    one exists (else the whole open bucket counts as slower — the
    conservative reading of censored mass)."""
    h = np.asarray(hist_row, np.float64)
    total = float(h.sum())
    if total <= 0.0:
        return 0.0
    e = np.asarray(edges, np.float64)
    b = float(bound_us)
    cum = np.cumsum(h)
    if b >= float(e[-1]):
        fit = fit_tail(h, edges=edges)
        if fit is not None:
            return min(fit.survival(b), float(h[-1]) / total)
        return float(h[-1]) / total
    i = int(np.searchsorted(e, b, side="left"))
    lo = 0.0 if i == 0 else float(e[i - 1])
    hi = float(e[i])
    below = 0.0 if i == 0 else float(cum[i - 1])
    inbin = float(h[i])
    frac_in = 0.0 if hi <= lo else (b - lo) / (hi - lo)
    le_bound = below + inbin * frac_in
    return max(0.0, (total - le_bound) / total)
