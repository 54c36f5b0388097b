"""SLO evaluator — continuous per-tenant objective evaluation.

Port of kubedtn_tpu/slo/evaluator.py. The ring reduction stays JAX's
numpy float64 sum over the host copy of each closed window
(telemetry.LinkTelemetry.window_sum), in the same order, so a verdict
equals JAX's on equal windows; the pass runs on the host whatever the
plane's device.

Fed ENTIRELY by existing on-device accumulators: the telemetry plane's
per-edge window ring (the fused tick chains it through in-flight
dispatches — zero extra dispatches) sliced per tenant by the
registry's columnar ownership masks, plus the admission controller's
cumulative throttle meters. Evaluation itself is pure host arithmetic
off the tick path:

- triggered once per telemetry WINDOW ROLLOVER (the background loop
  polls `windows_closed` — a counter read — and evaluates only when
  it advanced; queries can also force `maybe_evaluate`);
- per evaluation: ONE ring reduction per distinct burn-window span
  (vectorized numpy over the closed ring, shared by every tenant on
  that span) and O(tenants) Python work — a mask gather, a histogram
  row, and a handful of scalar comparisons per tenant (the JAX
  package budgets it as `slo_evaluate` in SCALE_BUDGET.json).

Objectives per tenant (slo.spec.SloSpec, defaults keyed off the QoS
class): a delivery-ratio floor and p99/p99.9 latency bounds, the
tails estimated PAST the bucket ladder's edge by the censored-tail
fit (slo.tail) instead of clamped to it. Burn rates run over two
window spans (fast = newest closed windows, slow = the ring) with the
two-window severity rule; the machine-readable `SloVerdict` feeds the
`kubedtn_slo_*` series, `Local.ObserveSLO`, the fleet merge
(slo.fleet), and `updates.gate.Guardrails.from_slo`.

Admission pressure: frames a tenant's own throttle parks at ingress
never reach the shaping kernels, so they are invisible to the window
ring — but they ARE unserved demand. The evaluator folds the average
parked backlog (the throttle meters' frame-tick delta over the ticks
since the last evaluation) into the delivery objective's BURN (an
aggressor backfilling 10× its budget burns hot), while the reported
`delivery_ratio` stays the shaping-plane truth (delivered/tx of
admitted frames) — so a throttled-but-lossless tenant reads
"attainment met, burn high", which is exactly what its budget says.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from kubedtn_tpu_torch import telemetry as tele
from kubedtn_tpu_torch.contracts import guarded_by
from kubedtn_tpu_torch.slo import tail as slo_tail
from kubedtn_tpu_torch.slo.spec import (SEV_PAGE, SEV_WARN, SloSpec,
                                        SloVerdict, severity_of)
from kubedtn_tpu_torch.utils.logging import fields as _fields
from kubedtn_tpu_torch.utils.logging import get_logger


@guarded_by("_lock", "evaluations", "windows_evaluated", "pages",
            "warns", "tail_fits", "censored_clamps")
class SloStats:
    """Cumulative evaluator counters for the kubedtn_slo_* series."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.evaluations = 0
        self.windows_evaluated = 0
        self.pages = 0
        self.warns = 0
        self.tail_fits = 0
        self.censored_clamps = 0

    def add(self, **kw) -> None:
        with self._lock:
            for k, v in kw.items():
                setattr(self, k, getattr(self, k) + v)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "evaluations": self.evaluations,
                "windows_evaluated": self.windows_evaluated,
                "pages": self.pages,
                "warns": self.warns,
                "tail_fits": self.tail_fits,
                "censored_clamps": self.censored_clamps,
            }


def _burns(spec: SloSpec, trow: np.ndarray, parked: float) -> float:
    """Max burn rate over the spec's objectives for one window slice
    `trow` ([KCOLS] tenant sums). Burn = observed error fraction /
    budgeted error fraction; parked frames count as unserved demand
    on the delivery objective (module docstring)."""
    tx = float(trow[tele.T_TX])
    delivered = float(trow[tele.T_DELIVERED])
    burn = 0.0
    demand = tx + parked
    if demand > 0.0:
        # clamp at 0: in-flight frames admitted BEFORE the span can
        # deliver inside it (delivered > tx+parked, e.g. under a full
        # admission hold), which is zero error, not negative burn
        err = max(0.0, (tx - delivered + parked) / demand)
        burn = err / (1.0 - spec.delivery_ratio_floor)
    hist = trow[tele.T_HIST0:]
    if tx > 0.0:
        if spec.p99_bound_us > 0.0:
            frac = slo_tail.fraction_slower_than(hist, spec.p99_bound_us)
            burn = max(burn, frac / 0.01)
        if spec.p999_bound_us > 0.0:
            frac = slo_tail.fraction_slower_than(hist,
                                                 spec.p999_bound_us)
            burn = max(burn, frac / 0.001)
    return burn


def evaluate_tenant(name: str, qos: str, spec: SloSpec,
                    slow_row: np.ndarray, slow_seconds: float,
                    fast_row: np.ndarray,
                    parked: float = 0.0) -> SloVerdict:
    """One tenant's verdict from its fast/slow window slices — the
    pure-arithmetic core, shared by the live evaluator and the fleet
    merge (slo.fleet re-runs it on plane-merged rows, so a fleet
    verdict and a single-plane verdict are the same computation)."""
    tx = float(slow_row[tele.T_TX])
    delivered = float(slow_row[tele.T_DELIVERED])
    hist = np.asarray(slow_row[tele.T_HIST0:], np.float64)
    ratio = (delivered / tx) if tx > 0.0 else None
    pcts = tele.percentiles_from_hist(hist, qs=(0.5,))
    p99, m99 = slo_tail.estimate_quantile(hist, 0.99)
    p999, method = slo_tail.estimate_quantile(hist, 0.999)
    fast_burn = _burns(spec, fast_row, parked)
    slow_burn = _burns(spec, slow_row, parked)
    attainment_ok = ratio is None or ratio >= spec.delivery_ratio_floor
    # a censored-clamp quantile is a LOWER bound: comparing it against
    # the objective would pass a tail we cannot see — leave that
    # verdict to the burn rate (the slower-than fraction is exact for
    # in-ladder bounds and fitted past the edge); interpolated and
    # tail-fit values are point estimates and compare directly
    latency_ok = True
    if (p99 is not None and spec.p99_bound_us > 0.0
            and m99 != slo_tail.METHOD_CENSORED):
        latency_ok = p99 <= spec.p99_bound_us
    if (latency_ok and p999 is not None and spec.p999_bound_us > 0.0
            and method != slo_tail.METHOD_CENSORED):
        latency_ok = p999 <= spec.p999_bound_us
    return SloVerdict(
        tenant=name, qos=qos, spec=spec,
        window_seconds=float(slow_seconds),
        tx=tx, delivered=delivered, delivery_ratio=ratio,
        p50_us=pcts["p50_us"],
        # censored = the REPORTED p99 is the clamp (real value >= it);
        # a successful tail fit is a point estimate, not a clamp
        p99_us=p99, p99_censored=m99 == slo_tail.METHOD_CENSORED,
        p999_us=p999, tail_method=method,
        throttle_backlog=float(parked),
        fast_burn=fast_burn, slow_burn=slow_burn,
        budget_remaining=max(0.0, 1.0 - slow_burn),
        attainment_ok=attainment_ok, latency_ok=latency_ok,
        severity=severity_of(spec, fast_burn, slow_burn),
        hist=[float(x) for x in hist],
    )


@guarded_by("_lock", "_specs", "_verdicts", "_meter_base",
            "_windows_seen")
class SloEvaluator:
    """Per-tenant SLO evaluation over one plane's telemetry ring.

    `evaluate()` runs one pass; `maybe_evaluate()` runs only when a
    telemetry window closed since the last pass (the rollover
    trigger); `start()` runs the trigger on a sidecar thread so the
    daemon evaluates continuously with zero tick-path involvement."""

    def __init__(self, registry, plane, stats: SloStats | None = None,
                 clock=time.monotonic) -> None:
        self.registry = registry
        self.plane = plane
        self.stats = stats if stats is not None else SloStats()
        self.clock = clock
        self.log = get_logger("slo")
        self._lock = threading.Lock()
        self._specs: dict[str, SloSpec] = {}     # per-tenant overrides
        self._verdicts: dict[str, SloVerdict] = {}
        # per-tenant (throttled_frame_ticks, plane.ticks) at the last
        # evaluation — the throttle-pressure baseline
        self._meter_base: dict[str, tuple[int, int]] = {}
        self._windows_seen = -1
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def attach(self, daemon) -> "SloEvaluator":
        """Install as the daemon's Local.ObserveSLO surface."""
        daemon.slo = self
        return self

    # -- spec management -----------------------------------------------

    def set_spec(self, tenant: str, spec: SloSpec | None) -> None:
        """Override (or with None, reset to the QoS default) one
        tenant's objectives."""
        with self._lock:
            if spec is None:
                self._specs.pop(tenant, None)
            else:
                self._specs[tenant] = spec

    def spec_for(self, tenant: str, qos: str = "gold") -> SloSpec:
        with self._lock:
            s = self._specs.get(tenant)
        return s if s is not None else SloSpec.for_qos(qos)

    # -- evaluation ----------------------------------------------------

    def maybe_evaluate(self) -> dict | None:
        """Evaluate iff a telemetry window closed since the last pass
        (one counter read when nothing changed) OR the tenant set
        changed (a tenant created on an idle plane must not wait for
        traffic to appear in `kdt slo`). Returns the fresh verdicts,
        or None when nothing changed."""
        t = getattr(self.plane, "telemetry", None)
        if t is None:
            return None
        closed = t.windows_closed
        names = {ten.name for ten in self.registry.list()}
        with self._lock:
            if (closed == self._windows_seen
                    and names == set(self._verdicts)):
                return None
            delta = max(0, closed - max(self._windows_seen, 0))
            self._windows_seen = closed
        self.stats.add(windows_evaluated=delta)
        return self.evaluate()

    def _throttle_pressure(self, name: str, ticks_now: int) -> float:
        """Average frames parked behind the tenant's throttle since
        the last evaluation (frame-tick delta / tick delta; the first
        pass averages over the plane's whole life) — 0 when
        unthrottled."""
        m = self.registry.admission.stats_for(name)
        ft = int(m["throttled_frame_ticks"])
        with self._lock:
            base_ft, base_ticks = self._meter_base.get(name, (0, 0))
            self._meter_base[name] = (ft, ticks_now)
        d_ticks = ticks_now - base_ticks
        if d_ticks <= 0:
            return 0.0
        return max(0.0, (ft - base_ft) / d_ticks)

    def evaluate(self) -> dict:
        """One O(tenants) evaluation pass over the closed-window ring.
        Returns {tenant: SloVerdict} (empty when telemetry is off)."""
        t = getattr(self.plane, "telemetry", None)
        reg = self.registry
        if t is None or reg is None:
            return {}
        tenants = reg.list()
        ticks_now = int(self.plane.ticks)
        # ONE ring reduction per distinct window span, shared across
        # every tenant evaluated on that span
        spans: dict[int, tuple] = {}

        def span(last: int):
            if last not in spans:
                spans[last] = t.window_sum(last=last, include_open=False)
            return spans[last]

        out: dict[str, SloVerdict] = {}
        pages = warns = fits = clamps = 0
        for ten in tenants:
            spec = self.spec_for(ten.name, qos=ten.qos)
            slow_total, slow_secs = span(spec.slow_windows)
            fast_total, _fs = span(spec.fast_windows)
            rows = reg.rows_of(ten.name)
            rows = rows[rows < slow_total.shape[0]]
            slow_row = slow_total[rows].sum(axis=0)
            fast_row = fast_total[rows[rows < fast_total.shape[0]]] \
                .sum(axis=0)
            parked = self._throttle_pressure(ten.name, ticks_now)
            v = evaluate_tenant(ten.name, ten.qos, spec, slow_row,
                                slow_secs, fast_row, parked=parked)
            out[ten.name] = v
            if v.severity == SEV_PAGE:
                pages += 1
                self.log.warning("slo page %s", _fields(
                    tenant=ten.name, fast_burn=round(v.fast_burn, 2),
                    slow_burn=round(v.slow_burn, 2),
                    budget_remaining=round(v.budget_remaining, 3)))
            elif v.severity == SEV_WARN:
                warns += 1
            if v.tail_method == slo_tail.METHOD_TAIL_FIT:
                fits += 1
            elif v.tail_method == slo_tail.METHOD_CENSORED:
                clamps += 1
        with self._lock:
            self._verdicts = out
            # prune departed tenants' throttle baselines (migration
            # RELEASE deletes tenants; churn must not grow this dict)
            for name in [n for n in self._meter_base if n not in out]:
                del self._meter_base[name]
        self.stats.add(evaluations=1, pages=pages, warns=warns,
                       tail_fits=fits, censored_clamps=clamps)
        return out

    def verdicts(self) -> dict:
        """Latest verdicts (evaluating first if a window rolled over
        since — queries never read a stale ring for free)."""
        fresh = self.maybe_evaluate()
        if fresh is not None:
            return fresh
        with self._lock:
            return dict(self._verdicts)

    def verdict_payloads(self, tenant: str = "") -> list[dict]:
        """Verdicts as wire-ready dicts (Local.ObserveSLO / the fleet
        merge), newest evaluation, optionally filtered to one
        tenant."""
        vs = self.verdicts()
        names = [tenant] if tenant else sorted(vs)
        return [vs[n].to_dict() for n in names if n in vs]

    # -- the continuous half (daemon sidecar) --------------------------

    def start(self, poll_s: float | None = None) -> None:
        """Background rollover watcher: polls `windows_closed` (a
        counter read) every `poll_s` — default a quarter of the
        telemetry window — and evaluates only on change."""
        if self._thread is not None:
            return
        t = getattr(self.plane, "telemetry", None)
        if poll_s is None:
            poll_s = max(0.05, (t.window_s if t is not None else 1.0)
                         / 4.0)

        def loop():
            while not self._stop.wait(poll_s):
                try:
                    self.maybe_evaluate()
                except Exception:
                    self.log.exception("slo evaluation failed "
                                       "(continuing)")

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="kdt-slo-eval")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None
        self._stop = threading.Event()


def evaluator_for(daemon) -> SloEvaluator | None:
    """The daemon's evaluator, creating (and attaching) one on first
    use when the daemon has both a tenancy registry and a telemetry-
    enabled plane — the lazy path the fleet merge and scenario
    harnesses use; cmd_daemon constructs its own eagerly."""
    ev = getattr(daemon, "slo", None)
    if ev is not None:
        return ev
    reg = getattr(daemon, "tenancy", None)
    plane = getattr(daemon, "dataplane", None)
    if (reg is None or plane is None
            or getattr(plane, "telemetry", None) is None):
        return None
    return SloEvaluator(reg, plane).attach(daemon)
