"""Prometheus metrics — name/label/bucket parity with the reference daemon.

Port of kubedtn_tpu/metrics/metrics.py: the same series, help strings,
labels and buckets the JAX package's daemon serves on :51112/metrics.

- `kubedtnd_request_duration_milliseconds{method}` histogram with buckets
  0,1,5,10,20,50,100,200,500,1000,2000,5000 and methods
  add|del|update|remoteUpdate|setup (reference
  daemon/metrics/latency_histograms.go:10-23, observed at
  daemon/kubedtn/handler.go:195,456,489,665).
- `interface_{rx,tx}_{packets,bytes}` and `interface_{rx,tx}_{errors,
  dropped}` gauges labeled (interface, pod, namespace) (reference
  daemon/metrics/interface_statistics.go:17-65). Where the reference walks
  every pod netns with netlink per scrape (:79-133), this collector reads
  the plane's cumulative counters (host arrays the plane adds to at each
  completion, written from the card's per-row sums) in one pass.
- `kubedtn_dataplane_*`, `kubedtn_peer_*`, `kubedtn_plane_shard_*`,
  `kubedtn_link_*`, `kubedtn_flight_*`, `kubedtn_whatif_*`,
  `kubedtn_update_*`, `kubedtn_pause_*` and
  `kubedtn_tick_latency_seconds{cause}`: the live plane's own series.
- `kubedtn_tenant_*` per tenant of the tenancy registry and
  `kubedtn_shm_*` from the shared-memory ingest plane.
- `kubedtn_slo_*` per tenant of the SLO evaluator and
  `kubedtn_autopilot_*` from the SLO autopilot, each with its per-tenant
  series cap.

Mapping from simulation taxa to interface counters:
- tx_dropped  ← netem loss + TBF queue + delay-ring drops (egress side)
- rx_errors   ← corrupt-flagged deliveries

Not ported yet: the migration and fleet collectors (the federation);
`make_registry` refuses their arguments with a ValueError naming the
collector. `prometheus_client` is imported by this
module only.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
from prometheus_client import CollectorRegistry, Histogram, generate_latest
from prometheus_client.core import (CounterMetricFamily,
                                     GaugeMetricFamily)

# Reference bucket edges (latency_histograms.go:15).
BUCKETS = (0, 1, 5, 10, 20, 50, 100, 200, 500, 1000, 2000, 5000)

HTTP_ADDR_DEFAULT = 51112  # reference common/constants.go:10 (":51112")


class LatencyHistograms:
    """kubedtnd_request_duration_milliseconds{method} (parity series)."""

    def __init__(self, registry: CollectorRegistry) -> None:
        self._h = Histogram(
            "kubedtnd_request_duration_milliseconds",
            "Latency of requests in milliseconds",
            ["method"],
            buckets=BUCKETS,
            registry=registry,
        )

    def observe(self, method: str, latency_ms: float) -> None:
        self._h.labels(method=method).observe(latency_ms)


class InterfaceStatsCollector:
    """interface_* gauges from the engine's realized links + sim counters.

    Scale guard: per-interface series are exported for up to
    `max_interfaces` realized link ends (the reference's practical
    ceiling is ~1K interfaces per node, grpcwire.go:276-283; the default
    here is 10×). Beyond that the per-interface tail is truncated —
    `kubedtn_interface_series_truncated` reports how many — because a
    100k-interface scrape is a multi-second, tens-of-MB exposition no
    Prometheus deployment wants. Node-level totals
    (`kubedtn_node_<counter>_total`) are always exported from one
    vectorized reduction, so aggregate visibility never truncates.
    """

    COUNTER_KEYS = ("tx_packets", "tx_bytes", "rx_packets", "rx_bytes",
                    "dropped_loss", "dropped_queue", "dropped_ring",
                    "rx_corrupted")

    def __init__(self, engine, sim_counters_fn=None,
                 max_interfaces: int = 10_000) -> None:
        self._engine = engine
        self._sim_counters_fn = sim_counters_fn
        self._max_interfaces = max_interfaces

    def collect(self):
        labels = ["interface", "pod", "namespace"]
        fams = {
            name: GaugeMetricFamily(f"interface_{name}", doc, labels=labels)
            for name, doc in [
                ("rx_packets", "Number of good packets received by the interface"),
                ("rx_bytes", "Number of good received bytes, corresponding to rx_packets"),
                ("tx_packets", "Number of packets successfully transmitted"),
                ("tx_bytes", "Number of good transmitted bytes, corresponding to tx_packets"),
                ("rx_errors", "Total number of bad packets received on this network device"),
                ("tx_errors", "Total number of transmit problems"),
                ("rx_dropped", "Number of packets received but not processed, e.g. due to lack of resources or unsupported protocol"),
                ("tx_dropped", "Number of packets dropped on their way to transmission, e.g. due to lack of resources"),
            ]
        }
        counters = self._sim_counters_fn() if self._sim_counters_fn else None
        out = list(fams.values())
        if counters is None:
            # no counters, no per-interface or node series: don't pay the
            # snapshot under the engine lock for nothing
            return out
        # one host transfer per array, then plain-list element access
        # (numpy scalar indexing per sample dominated large scrapes)
        arrs = {k: np.asarray(getattr(counters, k))
                for k in self.COUNTER_KEYS}
        c = {k: a.tolist() for k, a in arrs.items()}
        nrows = len(c["tx_packets"])
        # ONE locked engine read: snapshot + total + active rows, so the
        # truncation count and node totals are consistent with the
        # snapshot they accompany.
        snapshot, total_active, active_rows = \
            self._engine.metrics_snapshot(limit=self._max_interfaces)
        truncated = max(0, total_active - len(snapshot))
        # node totals over ACTIVE rows only: freed rows keep their
        # cumulative counters until reuse (delete clears uid/active/props
        # only), and a row realized after growth may not have a counter
        # slot until the next tick re-inits the arrays
        active_rows = active_rows[active_rows < nrows]
        for k, a in arrs.items():
            g = CounterMetricFamily(
                f"kubedtn_node_{k}",
                f"Node-wide sum of per-edge {k} over active links "
                "(never truncated)")
            g.add_metric([], float(a[active_rows].sum()))
            out.append(g)
        # Interface name from the spec is not tracked per row, so expose
        # uid-derived names the way the CRD samples do (eth<n> ordering is
        # a spec-level concern).
        for pod_key, uid, row, rev in snapshot:
            if row >= nrows:
                continue  # realized after growth, counters not yet sized
            ns, _, pod = pod_key.partition("/")
            lab = [f"uid{uid}", pod, ns]
            # tx = this row's egress; rx = reverse row's deliveries
            fams["tx_packets"].add_metric(lab, c["tx_packets"][row])
            fams["tx_bytes"].add_metric(lab, c["tx_bytes"][row])
            fams["tx_dropped"].add_metric(
                lab, c["dropped_loss"][row] + c["dropped_queue"][row]
                + c["dropped_ring"][row])
            fams["tx_errors"].add_metric(lab, 0.0)
            if rev is not None and rev < nrows:
                fams["rx_packets"].add_metric(lab, c["rx_packets"][rev])
                fams["rx_bytes"].add_metric(lab, c["rx_bytes"][rev])
                fams["rx_errors"].add_metric(lab, c["rx_corrupted"][rev])
                fams["rx_dropped"].add_metric(lab, 0.0)
        trunc = GaugeMetricFamily(
            "kubedtn_interface_series_truncated",
            "Realized link ends beyond the per-interface series cap "
            "(0 = full per-interface coverage)")
        trunc.add_metric([], float(truncated))
        out.append(trunc)
        return out


class DataPlaneStatsCollector:
    """kubedtn_dataplane_* counters from the wire data plane — the
    runtime-health series the reference has no analogue for (its data
    plane is kernel state): tick/shaping volume, bypass hits, orphaned
    releases, peer-forward errors, and ring backpressure drops."""

    SERIES = (
        ("ticks", "Data-plane ticks executed"),
        ("shaped", "Frames shaped through the netem/TBF chain"),
        ("dropped", "Frames dropped by shaping (loss/queue)"),
        ("bypassed", "Frames that skipped shaping via the TCP/IP bypass"),
        ("undeliverable",
         "Released frames whose wire never re-registered within grace"),
        ("forward_errors", "Failed per-frame forwards to peer daemons"),
        ("ring_dropped", "Frames lost to remote-stage ring overflow"),
        ("peer_queue_dropped",
         "Frames dropped at per-peer egress sender queues (slow peer)"),
        ("bulk_unresolved",
         "Bulk-transport frames whose wire id resolved to no wire"),
        ("tick_errors", "Tick failures survived by the runner"),
        ("peer_forward_retries",
         "Transient peer-send retry attempts (all peers)"),
        ("degradations",
         "Supervisor down-steps of the tick degradation ladder"),
        ("promotions",
         "Supervisor re-promotions back up the degradation ladder"),
        ("watchdog_stalls",
         "Watchdog observations of a stalled runner heartbeat"),
    )

    def __init__(self, plane) -> None:
        self._plane = plane

    def collect(self):
        plane = self._plane
        values = {
            "ticks": plane.ticks,
            "shaped": plane.shaped,
            "dropped": plane.dropped,
            "bypassed": plane.bypassed,
            "undeliverable": plane.undeliverable,
            "forward_errors": plane.daemon.forward_errors,
            "ring_dropped": plane.ring_dropped,
            "peer_queue_dropped": plane.peer_queue_dropped,
            "bulk_unresolved": plane.daemon.bulk_unresolved,
            "tick_errors": plane.tick_errors,
            "peer_forward_retries": plane.peer_retries,
            "degradations": plane.degradations,
            "promotions": plane.promotions,
            "watchdog_stalls": plane.watchdog_stalls,
        }
        out = []
        for name, doc in self.SERIES:
            g = CounterMetricFamily(f"kubedtn_dataplane_{name}", doc)
            g.add_metric([], float(values[name]))
            out.append(g)
        # tick-stage breakdown + pipeline gauges: the observability half
        # of the pipelined tick engine — where tick time goes (drain /
        # decide / kernel-dispatch / sync / schedule / release) and how
        # deep the overlap and the adaptive drain budget currently run
        bd = plane.stage_breakdown()
        stage = CounterMetricFamily(
            "kubedtn_dataplane_stage_seconds",
            "Cumulative wall seconds spent per tick stage "
            "(drain=ingress collection, decide=classify+bypass, "
            "kernel=device dispatch, sync=blocking on completed "
            "device outputs, schedule=wheel inserts+counters, "
            "release=due-frame delivery)", labels=["stage"])
        for k, v in bd["seconds"].items():
            stage.add_metric([k], float(v))
        out.append(stage)
        pipe = bd.get("pipeline", {})
        for name, key, doc in (
                ("pipeline_depth", "depth",
                 "Configured in-flight dispatch ring depth (1 = "
                 "synchronous tick)"),
                ("pipeline_inflight", "inflight",
                 "Shaping dispatches currently in flight on the device"),
                ("drain_budget", "drain_budget",
                 "Current adaptive per-wire drain budget "
                 "(frames per tick)"),
                ("ingress_backlog", "ingress_backlog",
                 "Ingress-deque entries the last drain left queued "
                 "(backpressure signal)"),
                ("holdback_wires", "holdback_wires",
                 "Wires with seq-cap residue deferred to the next "
                 "tick"),
                ("degrade_level", "degrade_level",
                 "Degradation-ladder rung (0=full pipeline, 1=depth-1, "
                 "2=synchronous un-fused)"),
                ("effective_pipeline_depth", "effective_depth",
                 "Pipeline depth actually in force after degradation")):
            g = GaugeMetricFamily(f"kubedtn_dataplane_{name}", doc)
            g.add_metric([], float(pipe.get(key, 0)))
            out.append(g)
        # runner heartbeat age (fault supervision): absent runner = -1
        hb = GaugeMetricFamily(
            "kubedtn_dataplane_heartbeat_age_seconds",
            "Seconds since the runner thread's last loop iteration "
            "(-1 while no runner is live); the watchdog counts ages "
            "beyond its timeout in kubedtn_dataplane_watchdog_stalls")
        age = plane.heartbeat_age_s
        hb.add_metric([], float(age) if age is not None else -1.0)
        out.append(hb)
        # per-peer circuit-breaker / retry / outage-buffer series — the
        # fault-domain face of the per-peer egress senders
        peers = plane.peer_fault_stats()
        if peers:
            state_g = GaugeMetricFamily(
                "kubedtn_peer_breaker_state",
                "Per-peer egress circuit-breaker state "
                "(0=closed, 1=open, 2=half-open)", labels=["peer"])
            opens_c = CounterMetricFamily(
                "kubedtn_peer_breaker_opens",
                "Cumulative breaker trips (closed/half-open -> open)",
                labels=["peer"])
            cycles_c = CounterMetricFamily(
                "kubedtn_peer_breaker_cycles",
                "Completed open -> half-open -> closed recovery cycles",
                labels=["peer"])
            retries_c = CounterMetricFamily(
                "kubedtn_peer_forward_retry",
                "Transient peer-send retry attempts", labels=["peer"])
            buffered_g = GaugeMetricFamily(
                "kubedtn_peer_outage_buffered",
                "Frames held in the peer's bounded outage buffer "
                "(queued + awaiting retry)", labels=["peer"])
            for addr, s in peers.items():
                lab = [addr]
                state_g.add_metric(lab, float(s["state"]))
                opens_c.add_metric(lab, float(s["opens"]))
                cycles_c.add_metric(lab, float(s["cycles"]))
                retries_c.add_metric(lab, float(s["retries"]))
                buffered_g.add_metric(lab, float(s["buffered"]))
            out.extend([state_g, opens_c, cycles_c, retries_c,
                        buffered_g])
        # sharded-plane series (kubedtn_plane_shard_*): emitted only
        # while the edge-state SoA is sharded across a mesh — mesh
        # size, per-shard edge counts, cross-shard frame volume, the
        # bounded mailbox's high-water mark, and the sampled
        # exchange-kernel seconds (extends the stage_seconds pattern
        # for work that rides INSIDE the one fused dispatch)
        shard = plane.shard_summary()
        if shard.get("enabled"):
            n_g = GaugeMetricFamily(
                "kubedtn_plane_shard_count",
                "Devices in the live plane's edge mesh")
            n_g.add_metric([], float(shard.get("n_shards", 1)))
            out.append(n_g)
            edges_g = GaugeMetricFamily(
                "kubedtn_plane_shard_edges",
                "Active edge rows owned by each shard of the edge "
                "mesh", labels=["shard"])
            for i, n in enumerate(shard.get("edges_per_shard") or []):
                edges_g.add_metric([str(i)], float(n))
            out.append(edges_g)
            imb_g = GaugeMetricFamily(
                "kubedtn_plane_shard_imbalance",
                "Per-shard edge-count imbalance (max/mean - 1)")
            imb_g.add_metric([], float(shard.get("imbalance", 0.0)))
            out.append(imb_g)
            x_c = CounterMetricFamily(
                "kubedtn_plane_shard_xshard_frames",
                "Frames whose next hop's edge row lives on a "
                "different shard (moved via the mailbox exchange)")
            x_c.add_metric([], float(shard.get("xshard_frames", 0)))
            out.append(x_c)
            hwm_g = GaugeMetricFamily(
                "kubedtn_plane_shard_mailbox_high_water",
                "Most mailbox rows any tick's ring exchange carried")
            hwm_g.add_metric([], float(shard.get("mailbox_hwm", 0)))
            out.append(hwm_g)
            ex_c = CounterMetricFamily(
                "kubedtn_plane_shard_exchange_seconds",
                "Sampled standalone re-executions of the tick's "
                "mailbox exchange, cumulative seconds (1/64 dispatch "
                "sampling — the ring itself rides inside the fused "
                "dispatch)")
            ex_c.add_metric([], float(shard.get("exchange_seconds",
                                                0.0)))
            out.append(ex_c)
        return out


class LinkTelemetryCollector:
    """kubedtn_link_* per-edge series from the data plane's window ring
    (telemetry.LinkTelemetry) — the per-link time-series the reference
    collapses into node aggregates. Same truncation-guard pattern as
    InterfaceStatsCollector: per-link series are exported for the
    busiest `max_links` links covered by the ring,
    `kubedtn_link_series_truncated` counts the tail, and the ring's
    coverage (windows closed, covered seconds) is always exported so a
    rate can be derived without scrape-interval guesswork."""

    VALUE_KEYS = (
        ("tx", "Frames offered to the shaping kernels in the ring's "
               "covered windows"),
        ("delivered", "Frames delivered through the qdisc chain"),
        ("dropped_loss", "Frames dropped by netem loss"),
        ("dropped_queue", "Frames dropped by TBF 50ms-queue overflow"),
        ("corrupted", "Frames delivered corrupt-flagged"),
        ("queue_depth", "Frames deferred to the holdback buffer"),
        ("delivered_pps", "Delivered frames/s over the covered span"),
        ("bytes_ps", "Delivered bytes/s over the covered span"),
    )
    QUANTILES = (("p50_us", "p50 shaping latency (µs) from the ring's "
                            "bucket counts"),
                 ("p99_us", "p99 shaping latency (µs) from the ring's "
                            "bucket counts"))

    def __init__(self, engine, dataplane, max_links: int = 1000) -> None:
        self._engine = engine
        self._plane = dataplane
        self._max_links = max_links

    def collect(self):
        out = []
        tel = getattr(self._plane, "telemetry", None)
        if tel is None:
            return out
        rows, seconds, truncated = tel.link_rows(self._engine)
        labels = ["interface", "pod", "namespace"]
        fams = {}
        for key, doc in self.VALUE_KEYS:
            fams[key] = GaugeMetricFamily(f"kubedtn_link_{key}", doc,
                                          labels=labels)
        for key, doc in self.QUANTILES:
            fams[key] = GaugeMetricFamily(f"kubedtn_link_{key}", doc,
                                          labels=labels)
        shown = rows[:self._max_links]
        for r in shown:
            lab = [f"uid{r['uid']}", r["pod"], r["namespace"]]
            for key, _doc in self.VALUE_KEYS:
                fams[key].add_metric(lab, float(r[key]))
            for key, _doc in self.QUANTILES:
                v = r[key]
                if v is not None and v != float("inf"):
                    fams[key].add_metric(lab, float(v))
        out.extend(fams.values())
        trunc = GaugeMetricFamily(
            "kubedtn_link_series_truncated",
            "Busy links beyond the per-link telemetry series cap "
            "(0 = full coverage)")
        trunc.add_metric([], float(truncated
                                   + max(0, len(rows) - len(shown))))
        out.append(trunc)
        cov = GaugeMetricFamily(
            "kubedtn_link_window_seconds",
            "Wall seconds covered by the exported window ring")
        cov.add_metric([], float(seconds))
        out.append(cov)
        wins = CounterMetricFamily(
            "kubedtn_link_windows_closed",
            "Telemetry windows closed since the plane started")
        wins.add_metric([], float(tel.windows_closed))
        out.append(wins)
        rec = getattr(self._plane, "recorder", None)
        if rec is not None:
            samp = CounterMetricFamily(
                "kubedtn_flight_sampled_frames",
                "Frames sampled into the flight recorder")
            samp.add_metric([], float(rec.sampled))
            out.append(samp)
            evc = CounterMetricFamily(
                "kubedtn_flight_events",
                "Lifecycle events recorded by the flight recorder")
            evc.add_metric([], float(rec.recorded))
            out.append(evc)
        return out


class WhatIfStatsCollector:
    """kubedtn_whatif_* counters — observability for daemon-served
    what-if sweeps (kubedtn_tpu_torch.twin.query): volume served (sweeps,
    scenarios, replicas, replica-steps) and where the device time went
    (compile vs run seconds), so an operator can see both the query
    load and whether the executable cache is doing its job."""

    SERIES = (
        ("sweeps_served", "What-if sweeps served"),
        ("scenarios_served", "Scenario replicas requested across sweeps"),
        ("replicas_run", "Replica lanes run (incl. baseline/padding)"),
        ("replica_steps_run",
         "Total replica-ticks advanced by the twin engine"),
        ("compile_seconds",
         "Wall seconds compiling sweep executables (one per "
         "(N,T,capacity) shape; 0 growth = warm cache)"),
        ("run_seconds", "Wall seconds executing compiled sweeps"),
        ("errors", "What-if requests rejected or failed"),
    )

    def __init__(self, stats) -> None:
        self._stats = stats

    def collect(self):
        snap = self._stats.snapshot()
        out = []
        for name, doc in self.SERIES:
            g = CounterMetricFamily(f"kubedtn_whatif_{name}", doc)
            g.add_metric([], float(snap[name]))
            out.append(g)
        return out


class UpdateStatsCollector:
    """kubedtn_update_* counters — observability for the planned-update
    change gate (kubedtn_tpu_torch.updates): plan volume and verdicts, gate
    latency, rounds staged through the live plane, and rollbacks — the
    numbers that say whether the twin gate is doing its job and how
    often staging has to undo itself."""

    SERIES = (
        ("plans_built", "Update plans built from topology deltas"),
        ("plans_verified", "Plans the twin gate verified"),
        ("plans_rejected", "Plans the twin gate rejected"),
        ("plan_errors", "Plan/gate infrastructure errors"),
        ("rounds_staged", "Update rounds landed on the live plane"),
        ("rollbacks", "Staged updates rolled back (regression or "
                      "dispatch failure)"),
        ("applies", "Staged updates fully applied"),
        ("applies_failed", "Staged updates that did not complete"),
        ("gate_seconds", "Wall seconds in the twin verification gate"),
        ("stage_seconds", "Wall seconds staging rounds (incl. watch "
                          "windows)"),
    )

    def __init__(self, stats) -> None:
        self._stats = stats

    def collect(self):
        snap = self._stats.snapshot()
        out = []
        for name, doc in self.SERIES:
            g = CounterMetricFamily(f"kubedtn_update_{name}", doc)
            g.add_metric([], float(snap[name]))
            out.append(g)
        return out


class PauseStatsCollector:
    """kubedtn_pause_* series from the data plane's PauseLedger
    (kubedtn_tpu_torch.pauses) — the barrier-pause attribution scrape face:
    per-cause pause seconds / event counts / worst + latest single
    pause, per-cause rows and bytes touched, and the
    tick-latency-by-cause histogram (`kubedtn_tick_latency_seconds
    {cause}`) on the reference bucket ladder rescaled to seconds.

    Cardinality guard (the SloStatsCollector truncation-guard
    pattern): the cause taxonomy is small and fixed, but an
    off-taxonomy cause is still recorded by the ledger — per-cause
    series are capped at `max_causes` (name-sorted, stable across
    scrapes) with the tail counted by
    `kubedtn_pause_causes_truncated`."""

    CAUSE_KEYS = (
        ("seconds_total", 1, "seconds", "Cumulative pause seconds "
         "attributed to this cause"),
        ("events_total", 1, "count", "Pause events recorded for this "
         "cause"),
        ("rows_total", 1, "rows", "Cumulative rows touched under this "
         "cause's barriers"),
        ("bytes_total", 1, "bytes", "Cumulative bytes touched under "
         "this cause's barriers"),
        ("max_seconds", 0, "max_s", "Worst single pause seen for this "
         "cause"),
        ("last_seconds", 0, "last_s", "Most recent pause duration for "
         "this cause"),
    )

    def __init__(self, dataplane, max_causes: int = 64) -> None:
        self._plane = dataplane
        self._max_causes = max_causes

    def collect(self):
        from prometheus_client.core import HistogramMetricFamily

        ledger = getattr(self._plane, "pauses", None)
        out = []
        if ledger is None:
            return out
        snap = ledger.snapshot()
        causes = sorted(snap["causes"])
        truncated = max(0, len(causes) - self._max_causes)
        fams = {}
        for key, is_counter, _src, doc in self.CAUSE_KEYS:
            fam_cls = CounterMetricFamily if is_counter \
                else GaugeMetricFamily
            fams[key] = fam_cls(f"kubedtn_pause_{key}", doc,
                                labels=["cause"])
        for cause in causes[:self._max_causes]:
            a = snap["causes"][cause]
            for key, _ic, src, _doc in self.CAUSE_KEYS:
                fams[key].add_metric([cause], float(a[src]))
        out.extend(fams.values())
        # tick-latency-by-cause: cumulative bucket counts on the
        # seconds ladder, "none" = ticks with no pause attributed
        hist = HistogramMetricFamily(
            "kubedtn_tick_latency_seconds",
            "Tick wall latency (tick-lock wait included) by the "
            "dominant pause cause attributed to that tick",
            labels=["cause"])
        edges = snap["tick_edges_s"]
        for cause in sorted(snap["tick_hist"])[:self._max_causes]:
            h = snap["tick_hist"][cause]
            cum = 0
            buckets = []
            for i, edge in enumerate(edges):
                cum += h["buckets"][i]
                buckets.append((repr(float(edge)), float(cum)))
            buckets.append(("+Inf", float(h["count"])))
            hist.add_metric([cause], buckets, sum_value=h["sum_s"])
        out.append(hist)
        g = GaugeMetricFamily(
            "kubedtn_pause_events_dropped",
            "Pause events that fell off the bounded event ring "
            "(aggregates never drop)")
        g.add_metric([], float(snap["dropped_events"]))
        out.append(g)
        trunc = GaugeMetricFamily(
            "kubedtn_pause_causes_truncated",
            "Causes beyond the per-cause series cap "
            "(0 = full coverage)")
        trunc.add_metric([], float(truncated))
        out.append(trunc)
        return out


class TenantStatsCollector:
    """kubedtn_tenant_* per-tenant series from the tenancy registry —
    the multi-tenant plane's observability face: per-tenant admission
    meters (admitted frames/bytes, typed throttle verdicts), the
    tenant's slice of the cumulative counters (tx / delivered /
    dropped-by-cause / bytes), its telemetry-window delivery rate and
    p99, QoS level and link count.

    Cardinality guard (the InterfaceStatsCollector truncation-guard
    pattern): per-tenant series are exported for at most `max_tenants`
    tenants (name-sorted, so the exported set is stable across
    scrapes); `kubedtn_tenant_series_truncated` reports how many fell
    past the cap — a runaway tenant-creation loop degrades to one
    guard gauge, never an unbounded label explosion."""

    COUNTER_KEYS = (
        ("admitted_frames", "Frames admitted past the tenant's "
                            "ingress token bucket"),
        ("admitted_bytes", "Bytes admitted past the tenant's ingress "
                           "token bucket"),
        ("throttle_events", "Typed admission throttle verdicts "
                            "(wire skipped for a tick, frames kept)"),
        ("throttled_frame_ticks",
         "Frame-ticks spent queued behind an admission throttle"),
        ("tx_packets", "Frames offered by this tenant's links"),
        ("delivered_packets", "Frames delivered on this tenant's "
                              "links"),
        ("delivered_bytes", "Bytes delivered on this tenant's links"),
        ("dropped_loss", "Tenant frames dropped by netem loss"),
        ("dropped_queue", "Tenant frames dropped by TBF queue "
                          "overflow"),
        ("dropped_ring", "Tenant frames dropped by egress ring "
                         "overflow"),
    )
    GAUGE_KEYS = (
        ("links", "Realized SoA rows owned by the tenant"),
        ("qos_level", "QoS class (0=gold, 1=silver, 2=bronze)"),
        ("frame_budget_per_s", "Admission frame budget (0=unlimited)"),
        ("byte_budget_per_s", "Admission byte budget (0=unlimited)"),
        ("delivered_pps", "Delivered frames/s over the telemetry "
                          "window span"),
        ("p99_us", "p99 shaping latency (µs) over the telemetry "
                   "window span"),
    )

    def __init__(self, tenancy, dataplane=None,
                 max_tenants: int = 256) -> None:
        self._tenancy = tenancy
        self._plane = dataplane
        self._max_tenants = max_tenants

    def collect(self):
        from kubedtn_tpu_torch.tenancy.registry import QOS_LEVELS

        reg = self._tenancy
        out = []
        # ONE ring reduction per scrape, sliced per tenant below —
        # not one full window_sum per tenant
        tel = (getattr(self._plane, "telemetry", None)
               if self._plane is not None else None)
        win_sum = tel.window_sum() if tel is not None else None
        tenants = sorted(reg.list(), key=lambda t: t.name)
        truncated = max(0, len(tenants) - self._max_tenants)
        shown = tenants[:self._max_tenants]
        fams = {}
        for key, doc in self.COUNTER_KEYS:
            fams[key] = CounterMetricFamily(f"kubedtn_tenant_{key}",
                                            doc, labels=["tenant"])
        for key, doc in self.GAUGE_KEYS:
            fams[key] = GaugeMetricFamily(f"kubedtn_tenant_{key}",
                                          doc, labels=["tenant"])
        for t in shown:
            lab = [t.name]
            adm = reg.admission.stats_for(t.name)
            vals = {
                "admitted_frames": t.admitted_frames,
                "admitted_bytes": t.admitted_bytes,
                "throttle_events": adm["throttle_events"],
                "throttled_frame_ticks": adm["throttled_frame_ticks"],
                "links": 0.0,
                "qos_level": QOS_LEVELS.get(t.qos, -1),
                "frame_budget_per_s": t.frame_budget_per_s,
                "byte_budget_per_s": t.byte_budget_per_s,
            }
            if self._plane is not None:
                c = reg.tenant_counters(self._plane, t.name)
                vals.update({
                    "links": c["links"],
                    "tx_packets": c["tx_packets"],
                    "delivered_packets": c["delivered_packets"],
                    "delivered_bytes": c["delivered_bytes"],
                    "dropped_loss": c["dropped_loss"],
                    "dropped_queue": c["dropped_queue"],
                    "dropped_ring": c["dropped_ring"],
                })
                win = reg.tenant_window(self._plane, t.name,
                                        window=win_sum)
                if win:
                    vals["delivered_pps"] = win["delivered_pps"]
                    if win["p99_us"] is not None:
                        vals["p99_us"] = win["p99_us"]
            for key, fam in fams.items():
                if key in vals:
                    fam.add_metric(lab, float(vals[key]))
        out.extend(fams.values())
        trunc = GaugeMetricFamily(
            "kubedtn_tenant_series_truncated",
            "Tenants beyond the per-tenant series cap "
            "(0 = full per-tenant coverage)")
        trunc.add_metric([], float(truncated))
        out.append(trunc)
        return out


class ShmStatsCollector:
    """kubedtn_shm_* series — the shared-memory ingest plane
    (kubedtn_tpu_torch.shm): attached/retired ring segments, dequeue volume
    (frames/bytes/native calls/plane batches), crash-skip accounting
    (uncommitted reservations crossed after a producer death), the
    admission face (throttle events at the ring head + frames left
    parked in-ring by the last drain), producer-side ring-full events
    summed across segments, and resolution failures (unknown wire ids,
    frames parked for unrealized links). One stats() snapshot per
    scrape — a handful of atomics and one lock hold, no ring walks."""

    COUNTERS = (
        ("frames_total", "frames_in", "Frames dequeued from shm rings "
                                      "into the data plane"),
        ("bytes_total", "bytes_in", "Payload bytes dequeued from shm "
                                    "rings"),
        ("dequeues_total", "dequeues", "Native batch-dequeue calls"),
        ("batches_total", "batches", "Plane batches emitted from ring "
                                     "spans"),
        ("skipped_uncommitted_total", "skipped_uncommitted",
         "Uncommitted reservations skipped after a producer death "
         "(torn frames never surface; committed frames never lost)"),
        ("throttled_events_total", "throttled_events",
         "Drains that left a ring parked by per-tenant admission at "
         "the ring head"),
        ("unresolved_frames_total", "unresolved_frames",
         "Ring frames whose wire id resolved to no registered wire"),
        ("parked_unrealized_total", "parked_unrealized",
         "Ring frames parked on wire ingress awaiting link "
         "realization"),
        ("rings_retired_total", "rings_retired",
         "Dead producers' rings detached after fully draining"),
        ("producer_full_failures_total", "full_failures",
         "Producer-side pushes rejected ring-full (queued in the "
         "sender's outage buffer, never dropped)"),
    )
    GAUGES = (
        ("rings", "rings", "Ring segments currently attached"),
        ("pending_frames", "pending",
         "Entries reserved and unconsumed across attached rings"),
        ("throttled_parked_frames", "throttled_frames_last",
         "Frames left parked in-ring by admission on the last drain"),
    )

    def __init__(self, shm) -> None:
        self._shm = shm

    def collect(self):
        snap = self._shm.stats()
        out = []
        for name, key, doc in self.COUNTERS:
            c = CounterMetricFamily(f"kubedtn_shm_{name}", doc)
            c.add_metric([], float(snap[key]))
            out.append(c)
        for name, key, doc in self.GAUGES:
            g = GaugeMetricFamily(f"kubedtn_shm_{name}", doc)
            g.add_metric([], float(snap[key]))
            out.append(g)
        return out


class SloStatsCollector:
    """kubedtn_slo_* series from the SLO evaluator (kubedtn_tpu_torch.slo) —
    the observability plane's scrape face: per-tenant attainment vs
    target, estimated latency tails (past the bucket ladder via the
    censored-tail fit; the companion `censored` gauge says when even
    the fit had to clamp), multi-window burn rates, remaining error
    budget and severity, plus evaluator volume counters.

    Cardinality guard (the InterfaceStatsCollector truncation-guard
    pattern): per-tenant series for at most `max_tenants` tenants
    (name-sorted, stable across scrapes), the tail counted by
    `kubedtn_slo_series_truncated`. Scrapes read the LATEST verdicts;
    the evaluator re-evaluates first only when a telemetry window
    rolled over since (one counter read otherwise)."""

    GAUGE_KEYS = (
        ("attainment", "Delivery ratio over the slow burn window "
                       "(-1 = no traffic observed)"),
        ("target", "The tenant's SLO delivery-ratio floor"),
        ("p99_us", "Estimated p99 shaping latency (µs; censored-tail "
                   "fit past the bucket ladder)"),
        ("p999_us", "Estimated p99.9 shaping latency (µs)"),
        ("p99_censored", "1 = the p99 is clamped at the ladder's open "
                         "top bucket (real value >= reported)"),
        ("fast_burn", "Error-budget burn rate over the fast window"),
        ("slow_burn", "Error-budget burn rate over the slow window"),
        ("budget_remaining", "Fraction of the slow-window error "
                             "budget left (0 = exhausted)"),
        ("throttle_backlog", "Average frames parked behind the "
                             "tenant's admission throttle"),
        ("severity", "Verdict severity (0=ok, 1=warn, 2=page)"),
    )
    COUNTER_SNAP = (
        ("evaluations", "SLO evaluation passes run"),
        ("windows_evaluated", "Telemetry window rollovers evaluated"),
        ("pages", "Page-severity verdicts emitted"),
        ("warns", "Warn-severity verdicts emitted"),
        ("tail_fits", "Verdicts whose p99.9 came from the "
                      "censored-tail fit (estimated past the ladder)"),
        ("censored_clamps", "Verdicts whose p99.9 fell back to the "
                            "censored clamp (tail fit refused)"),
    )

    def __init__(self, evaluator, max_tenants: int = 256) -> None:
        self._ev = evaluator
        self._max_tenants = max_tenants

    def collect(self):
        from kubedtn_tpu_torch.slo.spec import SEVERITY_LEVELS

        out = []
        verdicts = self._ev.verdicts()
        names = sorted(verdicts)
        truncated = max(0, len(names) - self._max_tenants)
        fams = {}
        for key, doc in self.GAUGE_KEYS:
            fams[key] = GaugeMetricFamily(f"kubedtn_slo_{key}", doc,
                                          labels=["tenant"])
        for name in names[:self._max_tenants]:
            v = verdicts[name]
            lab = [name]
            vals = {
                "attainment": (-1.0 if v.delivery_ratio is None
                               else v.delivery_ratio),
                "target": v.spec.delivery_ratio_floor,
                "p99_us": -1.0 if v.p99_us is None else v.p99_us,
                "p999_us": -1.0 if v.p999_us is None else v.p999_us,
                "p99_censored": 1.0 if v.p99_censored else 0.0,
                "fast_burn": v.fast_burn,
                "slow_burn": v.slow_burn,
                "budget_remaining": v.budget_remaining,
                "throttle_backlog": v.throttle_backlog,
                "severity": SEVERITY_LEVELS.get(v.severity, -1),
            }
            for key, fam in fams.items():
                fam.add_metric(lab, float(vals[key]))
        out.extend(fams.values())
        snap = self._ev.stats.snapshot()
        for key, doc in self.COUNTER_SNAP:
            c = CounterMetricFamily(f"kubedtn_slo_{key}", doc)
            c.add_metric([], float(snap[key]))
            out.append(c)
        trunc = GaugeMetricFamily(
            "kubedtn_slo_series_truncated",
            "Tenants beyond the per-tenant SLO series cap "
            "(0 = full coverage)")
        trunc.add_metric([], float(truncated))
        out.append(trunc)
        return out


class AutopilotStatsCollector:
    """kubedtn_autopilot_* series from the SLO autopilot
    (kubedtn_tpu_torch.autopilot) — the remediation loop's scrape face: the
    loop switches (enabled / dry-run / sidecar running), each tenant's
    state-machine position and hysteresis counters, and the cumulative
    action ledger (pages seen, searches run, deltas staged / rejected
    / rolled back, escalations) plus where the wall time went (sweep
    compile vs run, time-to-green).

    Cardinality guard (the SloStatsCollector truncation-guard
    pattern): per-tenant series for at most `max_tenants` tenants,
    name-sorted so the kept set is stable across scrapes, the tail
    counted by `kubedtn_autopilot_series_truncated`."""

    GAUGE_KEYS = (
        ("state", "Autopilot state machine position (0=observe, "
                  "1=search, 2=stage, 3=verify, 4=hold)"),
        ("pages", "Consecutive paging polls observed (hysteresis "
                  "counter; resets on remediation or recovery)"),
        ("fails", "Consecutive failed remediations (feeds fleet "
                  "escalation)"),
        ("hold_remaining_s", "Seconds of cooldown left before the "
                             "tenant can page again (0 = armed)"),
    )
    COUNTER_SNAP = (
        ("pages_seen", "Page-severity verdicts that entered the loop"),
        ("searches_run", "Candidate sweeps run (one batched twin "
                         "sweep each)"),
        ("candidates_evaluated", "Candidate replicas scored across "
                                 "all sweeps"),
        ("deltas_staged", "Winning deltas staged onto the live plane"),
        ("deltas_rolled_back", "Staged deltas the watch rolled back"),
        ("deltas_rejected", "Winning deltas the twin gate rejected"),
        ("quota_actions", "Admission-plane actions (quota trim / "
                          "drain boost)"),
        ("escalations", "Fleet rebalance escalations triggered"),
        ("no_candidate", "Searches where nothing beat the baseline"),
        ("dry_runs", "Actions evaluated but not staged (dry-run)"),
        ("greens", "Remediations verified back below page severity"),
        ("stales", "Remediations that never went green in the verify "
                   "window"),
        ("errors", "Remediation attempts that raised"),
        ("time_to_green_s", "Wall seconds from page to verified "
                            "green, summed"),
        ("sweep_compile_s", "Wall seconds compiling candidate sweeps"),
        ("sweep_run_s", "Wall seconds executing candidate sweeps"),
    )

    def __init__(self, autopilot, max_tenants: int = 256) -> None:
        self._ap = autopilot
        self._max_tenants = max_tenants

    def collect(self):
        from kubedtn_tpu_torch.autopilot.controller import STATE_LEVELS

        st = self._ap.status()
        out = []
        for key, doc in (("enabled", "1 = the autopilot acts on pages"),
                         ("dry_run", "1 = evaluate and gate only, "
                                     "stage nothing"),
                         ("running", "1 = the sidecar poll thread is "
                                     "alive")):
            g = GaugeMetricFamily(f"kubedtn_autopilot_{key}", doc)
            g.add_metric([], 1.0 if st[key] else 0.0)
            out.append(g)
        tenants = st["tenants"]
        names = sorted(tenants)
        truncated = max(0, len(names) - self._max_tenants)
        fams = {}
        for key, doc in self.GAUGE_KEYS:
            fams[key] = GaugeMetricFamily(f"kubedtn_autopilot_{key}",
                                          doc, labels=["tenant"])
        for name in names[:self._max_tenants]:
            t = tenants[name]
            lab = [name]
            vals = {
                "state": STATE_LEVELS.get(t["state"], -1),
                "pages": t["pages"],
                "fails": t["fails"],
                "hold_remaining_s": t["hold_remaining_s"],
            }
            for key, fam in fams.items():
                fam.add_metric(lab, float(vals[key]))
        out.extend(fams.values())
        snap = st["stats"]
        for key, doc in self.COUNTER_SNAP:
            c = CounterMetricFamily(f"kubedtn_autopilot_{key}", doc)
            c.add_metric([], float(snap[key]))
            out.append(c)
        trunc = GaugeMetricFamily(
            "kubedtn_autopilot_series_truncated",
            "Tenants beyond the per-tenant autopilot series cap "
            "(0 = full coverage)")
        trunc.add_metric([], float(truncated))
        out.append(trunc)
        return out


class MetricsServer:
    """Serves the registry on an HTTP port — the daemon's :51112/metrics
    endpoint (reference daemon/main.go:57-66)."""

    def __init__(self, registry: CollectorRegistry,
                 port: int = HTTP_ADDR_DEFAULT,
                 host: str = "0.0.0.0") -> None:
        self.registry = registry
        reg = registry

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                if self.path not in ("/metrics", "/"):
                    self.send_response(404)
                    self.end_headers()
                    return
                # a collector raising mid-scrape must cost THIS scrape a
                # 500, not the handler thread (an unhandled exception
                # would reset the connection and log a traceback per
                # scrape) — subsequent scrapes see the registry afresh
                try:
                    body = generate_latest(reg)
                except Exception as e:
                    err = f"# scrape failed: {type(e).__name__}: {e}\n"
                    self.send_response(500)
                    self.send_header("Content-Type", "text/plain")
                    self.end_headers()
                    try:
                        self.wfile.write(err.encode())
                    except OSError:
                        pass
                    return
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silence
                pass

        # all interfaces by default: off-host Prometheus must reach the
        # scrape endpoint, like the reference's :51112 (daemon/main.go:62-66)
        self._srv = ThreadingHTTPServer((host, port), Handler)
        self.port = self._srv.server_port

    def start(self) -> None:
        t = threading.Thread(target=self._srv.serve_forever, daemon=True)
        t.start()

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()  # release the listening socket


# make_registry's arguments whose collectors are not ported yet
_NOT_PORTED = {"migration_stats": "MigrationStatsCollector",
               "fleet": "FleetStatsCollector"}


def make_registry(engine=None, sim_counters_fn=None,
                  max_interfaces: int = 10_000, dataplane=None,
                  whatif_stats=None, update_stats=None, tenancy=None,
                  max_tenants: int = 256, migration_stats=None,
                  fleet=None, slo=None, shm=None, autopilot=None):
    """Registry with the parity collectors installed, and the request
    histogram (the JAX package's signature). Passing an argument whose
    collector is not ported yet raises ValueError naming it."""
    given = {"migration_stats": migration_stats, "fleet": fleet}
    for arg, value in given.items():
        if value is not None:
            raise ValueError(
                f"make_registry({arg}=...): {_NOT_PORTED[arg]} is not "
                f"ported to kubedtn_tpu_torch yet")
    registry = CollectorRegistry()
    hist = LatencyHistograms(registry)
    if engine is not None:
        registry.register(InterfaceStatsCollector(
            engine, sim_counters_fn, max_interfaces=max_interfaces))
    if dataplane is not None:
        registry.register(DataPlaneStatsCollector(dataplane))
        registry.register(PauseStatsCollector(dataplane))
        if engine is not None:
            # emits nothing until the plane's telemetry is enabled
            registry.register(LinkTelemetryCollector(engine, dataplane))
    if whatif_stats is not None:
        registry.register(WhatIfStatsCollector(whatif_stats))
    if update_stats is not None:
        registry.register(UpdateStatsCollector(update_stats))
    if tenancy is not None:
        registry.register(TenantStatsCollector(
            tenancy, dataplane, max_tenants=max_tenants))
    if slo is not None:
        registry.register(SloStatsCollector(slo,
                                            max_tenants=max_tenants))
    if shm is not None:
        registry.register(ShmStatsCollector(shm))
    if autopilot is not None:
        registry.register(AutopilotStatsCollector(
            autopilot, max_tenants=max_tenants))
    return registry, hist
