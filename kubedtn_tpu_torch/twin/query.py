"""Daemon-side what-if query surface.

`Local.WhatIf` (a framework extension of the reference IDL, like
InjectBulk) lets any client ask a LIVE daemon "what would your network
do under these futures": the handler forks a consistent snapshot of
the running data plane (snapshot_from_plane's flush barrier — the
real-time runner keeps ticking, zero frame loss), compiles the
request's scenarios, runs the batched replica sweep on device, and
returns ranked per-scenario metrics. Sweep counts, replica volume and
the compile/run split accumulate in `WhatIfStats` (exported as
`kubedtn_whatif_*` by metrics/metrics.py).

Port of kubedtn_tpu/twin/query.py. A request naming a tenant is served
from a fork scoped to that tenant's rows (registry.tenant_snapshot) and
takes that tenant's sweep slot; it is refused as unknown when the daemon
has no tenancy registry or the registry lacks the name. The tracing
span around a sweep comes with the port's tracing module.
"""

from __future__ import annotations

import threading

from kubedtn_tpu_torch.twin.report import rank_results
from kubedtn_tpu_torch.twin.snapshot import snapshot_from_engine, \
    snapshot_from_plane
from kubedtn_tpu_torch.twin.spec import Perturbation, Scenario

DEFAULT_TICKS = 1000
DEFAULT_DT_US = 1000.0
DEFAULT_RATE_BPS = 1e6
DEFAULT_PKT_BYTES = 200.0
MAX_TICKS = 200_000
MAX_SCENARIOS = 1024
# k_slots is a STATIC compile parameter sizing the [E, K] slot arrays
# and the K-sequential qdisc scan — unbounded it defeats every other
# ceiling here via one enormous trace/compile
MAX_K_SLOTS = 64
# per-request work and memory ceilings: ticks and scenario count are
# each bounded above, but their PRODUCT (and the replica-broadcast
# footprint replicas × edge capacity) is what a gRPC worker actually
# pays — one in-limit 1024×200k request would otherwise pin a worker
# for hours (CPU) or OOM the daemon serving the live plane
MAX_REPLICA_STEPS = 2_000_000
MAX_REPLICA_CELLS = 4_000_000
# concurrent sweeps allowed per daemon: a sweep can legitimately run
# for minutes on a slow host, and the gRPC pool has 16 workers shared
# with the LIVE data plane's peer RPCs — unbounded concurrent sweeps
# would starve those (breakers open, outage buffers fill). One sweep
# computes at a time; a second request waits briefly, then is refused
# loudly instead of parking a worker.
#
# TENANT SCOPING: the single-sweep slot is per TENANT — one
# tenant's long sweep can no longer park every other tenant's
# Local.WhatIf behind a global lock. Untenanted requests share the ""
# pool. A small PROCESS-WIDE cap still bounds total concurrency so N
# tenants cannot occupy the whole gRPC worker pool with sweeps.
MAX_CONCURRENT_SWEEPS = 1
MAX_PROCESS_SWEEPS = 4
SWEEP_WAIT_S = 10.0


class WhatIfStats:
    """Cumulative counters behind the kubedtn_whatif_* series of the
    JAX package's exporter."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.sweeps = 0
        self.scenarios = 0
        self.replicas = 0
        self.replica_steps = 0
        self.compile_s = 0.0
        self.run_s = 0.0
        self.errors = 0

    def record(self, result, n_scenarios: int) -> None:
        with self._lock:
            self.sweeps += 1
            self.scenarios += n_scenarios
            self.replicas += result.replicas
            self.replica_steps += result.replicas * result.ticks
            self.compile_s += result.compile_s
            self.run_s += result.run_s

    def record_error(self) -> None:
        with self._lock:
            self.errors += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "sweeps_served": self.sweeps,
                "scenarios_served": self.scenarios,
                "replicas_run": self.replicas,
                "replica_steps_run": self.replica_steps,
                "compile_seconds": self.compile_s,
                "run_seconds": self.run_s,
                "errors": self.errors,
            }


_ATTACH_LOCK = threading.Lock()  # guards first-use attachment races


def stats_for(daemon) -> WhatIfStats:
    """The daemon's WhatIfStats, created on first use."""
    with _ATTACH_LOCK:
        st = getattr(daemon, "whatif_stats", None)
        if st is None:
            st = daemon.whatif_stats = WhatIfStats()
        return st


def _sweep_slots(daemon, tenant: str = "") -> threading.BoundedSemaphore:
    """The sweep-concurrency slot for one tenant ("" = the untenanted
    shared pool): a bounded per-tenant pool, created on first use, so
    tenants queue behind THEIR OWN sweeps only."""
    with _ATTACH_LOCK:
        slots = getattr(daemon, "_whatif_slots", None)
        if slots is None or not isinstance(slots, dict):
            slots = daemon._whatif_slots = {}
        sem = slots.get(tenant)
        if sem is None:
            sem = slots[tenant] = threading.BoundedSemaphore(
                MAX_CONCURRENT_SWEEPS)
        return sem


def _process_slots(daemon) -> threading.BoundedSemaphore:
    """Process-wide sweep cap across ALL tenants (gRPC-pool guard)."""
    with _ATTACH_LOCK:
        sem = getattr(daemon, "_whatif_process_slots", None)
        if sem is None:
            sem = daemon._whatif_process_slots = \
                threading.BoundedSemaphore(MAX_PROCESS_SWEEPS)
        return sem


def build_cbr_spec(edges, rate_bps: float = DEFAULT_RATE_BPS,
                   pkt_bytes: float = DEFAULT_PKT_BYTES):
    """The sweep's default offered load: CBR on every ACTIVE edge. The
    ONE construction both query modes use — `kdt whatif --daemon` and
    `--file` must answer the same question for the same flags, so the
    defaults live here, not in copies."""
    import dataclasses

    import torch

    from kubedtn_tpu_torch.models.traffic import cbr_everywhere

    cap = edges.capacity
    spec = cbr_everywhere(cap, cap, rate_bps=rate_bps,
                          pkt_bytes=pkt_bytes, device=edges.device)
    return dataclasses.replace(
        spec, mode=torch.where(edges.active, spec.mode, 0))


def scenarios_from_request(request, props_from_proto) -> list:
    """Wire → spec translation. Proto3 scalars carry no presence, so
    fields are interpreted BY KIND rather than by truthiness — a scale
    factor of 0 ("this source stops") and a link uid of 0 are both
    legal values and must not silently coerce to defaults."""
    out = []
    for sc in request.scenarios:
        perts = []
        for p in sc.perturbations:
            kind = p.kind or "degrade"
            perts.append(Perturbation(
                kind=kind,
                uid=(int(p.uid) if kind in ("degrade", "fail")
                     else None),
                props=(props_from_proto(p.properties)
                       if kind == "degrade" else None),
                node=p.node or None,
                factor=p.factor if kind == "scale" else 1.0,
            ))
        out.append(Scenario(name=sc.name or f"scenario{len(out)}",
                            perturbations=tuple(perts)))
    return out


def serve_whatif(daemon, request):
    """The Local.WhatIf handler body (imported lazily by the daemon so
    the twin engine costs nothing until the first query)."""
    from kubedtn_tpu_torch.twin.engine import run_sweep
    from kubedtn_tpu_torch.wire import proto as pb

    stats = stats_for(daemon)
    try:
        ticks = int(request.ticks) or DEFAULT_TICKS
        if not 0 < ticks <= MAX_TICKS:
            raise ValueError(f"ticks must be in (0, {MAX_TICKS}]")
        dt_us = float(request.dt_us) or DEFAULT_DT_US
        if dt_us <= 0:
            raise ValueError("dt_us must be positive")
        if len(request.scenarios) > MAX_SCENARIOS:
            raise ValueError(f"at most {MAX_SCENARIOS} scenarios per "
                             f"sweep")
        k_slots = int(request.k_slots) or 4
        if not 0 < k_slots <= MAX_K_SLOTS:
            raise ValueError(f"k_slots must be in (0, {MAX_K_SLOTS}]")
        scenarios = scenarios_from_request(request, pb.props_from_proto)
        if request.include_baseline or not scenarios:
            scenarios = [Scenario(name="baseline"), *scenarios]
        names = [sc.name for sc in scenarios]
        if len(set(names)) != len(names):
            # ranks (server AND client side) key by name: a duplicate —
            # including a user scenario named "baseline" next to the
            # injected one — would collapse two lanes' ranks silently
            raise ValueError(
                "scenario names must be unique ('baseline' is reserved "
                "when include_baseline is set)")

        n_replicas = len(scenarios)
        if n_replicas * ticks > MAX_REPLICA_STEPS:
            raise ValueError(
                f"scenarios × ticks = {n_replicas * ticks} exceeds the "
                f"per-request budget {MAX_REPLICA_STEPS}")

        # sweeps compute for seconds-to-minutes: bound how many run at
        # once so they can never occupy the gRPC pool the live data
        # plane's peer RPCs share — refuse loudly rather than park.
        # The slot is PER TENANT (plus a process-wide cap): tenant A's
        # sweep never parks tenant B's Local.WhatIf.
        tenant = getattr(request, "tenant", "") or ""
        registry = getattr(daemon, "tenancy", None)
        if tenant and (registry is None
                       or registry.get(tenant) is None):
            raise ValueError(f"unknown tenant {tenant!r}")
        slots = _sweep_slots(daemon, tenant)
        if not slots.acquire(timeout=SWEEP_WAIT_S):
            raise RuntimeError(
                f"another what-if sweep is in progress for "
                f"{'tenant ' + tenant if tenant else 'this daemon'}; "
                f"retry later")
        proc = _process_slots(daemon)
        if not proc.acquire(timeout=SWEEP_WAIT_S):
            slots.release()
            raise RuntimeError(
                "the daemon-wide what-if concurrency cap is occupied; "
                "retry later")
        try:
            plane = getattr(daemon, "dataplane", None)
            if tenant:
                # tenant-scoped fork: only this tenant's edge slice is
                # active in the replicas (registry.tenant_snapshot)
                snap = registry.tenant_snapshot(
                    plane if plane is not None else daemon.engine,
                    tenant)
            elif plane is not None:
                snap = snapshot_from_plane(plane)
            else:
                snap = snapshot_from_engine(daemon.engine)
            if n_replicas * snap.sim.edges.capacity > MAX_REPLICA_CELLS:
                raise ValueError(
                    f"scenarios × edge capacity = "
                    f"{n_replicas * snap.sim.edges.capacity} exceeds the "
                    f"replica-broadcast budget {MAX_REPLICA_CELLS}")
            with daemon.engine._lock:
                pod_ids = dict(daemon.engine._pod_ids)

            # proto3 presence convention (as for ticks/dt_us/k_slots):
            # 0 means UNSET → default. Zero offered load is expressed
            # with a scale-0 scenario, never a zero rate; negatives are
            # rejected rather than fed to the generator.
            rate = float(request.traffic_rate_bps) or DEFAULT_RATE_BPS
            pkt = float(request.traffic_pkt_bytes) or DEFAULT_PKT_BYTES
            if rate < 0 or pkt < 0:
                raise ValueError(
                    "traffic_rate_bps/traffic_pkt_bytes must be "
                    "positive (0 = default; use a scale-0 scenario "
                    "for zero offered load)")
            spec = build_cbr_spec(snap.sim.edges, rate_bps=rate,
                                  pkt_bytes=pkt)

            result = run_sweep(
                snap, scenarios, steps=ticks, dt_us=dt_us, spec=spec,
                k_slots=k_slots, seed=int(request.seed),
                pod_ids=pod_ids)
        finally:
            proc.release()
            slots.release()
    except Exception as e:  # a bad query must not kill the worker
        stats.record_error()
        from kubedtn_tpu_torch.utils.logging import fields, get_logger

        get_logger("whatif").warning(
            "whatif sweep failed %s",
            fields(error=f"{type(e).__name__}: {e}"))
        return pb.WhatIfResponse(ok=False,
                                 error=f"{type(e).__name__}: {e}")

    stats.record(result, len(scenarios))
    ranks = {name: r for name, _m, r in rank_results(result)}
    msgs = []
    for name, m in zip(result.names, result.metrics):
        msgs.append(pb.WhatIfMetrics(
            name=name,
            tx_packets=m["tx_packets"],
            delivered_packets=m["delivered_packets"],
            delivered_bytes=m["delivered_bytes"],
            dropped_loss=m["dropped_loss"],
            dropped_queue=m["dropped_queue"],
            dropped_ring=m["dropped_ring"],
            throughput_bps=m["throughput_bps"],
            delivery_ratio=(m["delivery_ratio"]
                            if m["delivery_ratio"] is not None else -1.0),
            p50_us=m["p50_us"] if m["p50_us"] is not None else -1.0,
            p90_us=m["p90_us"] if m["p90_us"] is not None else -1.0,
            p99_us=m["p99_us"] if m["p99_us"] is not None else -1.0,
            p99_censored=bool(m.get("p99_censored", False)),
            mean_queue_occupancy=m["mean_queue_occupancy"],
            latency_hist=m["latency_hist"],
            rank=ranks[name],
        ))
    return pb.WhatIfResponse(
        ok=True, results=msgs, replicas=result.replicas,
        ticks=result.ticks, sim_seconds=result.sim_seconds,
        compile_s=result.compile_s, run_s=result.run_s,
        replicas_steps_per_s=result.replicas_steps_per_s)
