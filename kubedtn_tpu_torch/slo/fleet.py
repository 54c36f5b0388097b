"""Fleet-wide SLO aggregation — exact histogram merge + migration stitch.

Port of kubedtn_tpu/slo/fleet.py (numpy, unchanged). The port has no
federation yet: the frozen slices come from its migration journal, so
`from_frozen_window` and `fleet_slo(frozen=...)` have no caller in the
package until it does; ObserveSLO's fleet branch waits for the fleet
supervisor likewise.

Every plane's telemetry rings share ONE reference bucket ladder
(telemetry.BUCKET_EDGES_US), so per-tenant window histograms from
different planes are EXACTLY mergeable: merged bucket counts are sums,
and any percentile of the merged histogram equals the percentile the
single-plane computation would produce over the pooled samples — no
approximation, no re-binning (pinned by the bit-equality property
test in tests/test_slo.py).

The merge's second input is the migration journal: when a tenant is
live-migrated or evacuated, its source plane's window
slice is FROZEN into the record at RECONCILE — exactly the pre-move
observation that would otherwise vanish when RELEASE deregisters the
tenant. A fleet verdict for a migrated tenant therefore stitches:

    frozen src window slice  +  live dst window slice

giving a CONTINUOUS fleet-level view across the move — attainment,
estimated tails, and error budget computed over the pooled histogram
by the very same `evaluate_tenant` arithmetic a single plane uses.

Contributions are plain dicts (the wire's SloTenant rows and the
journal's frozen slices both map onto them), so the merge runs
identically server-side (FleetSupervisor.fleet_slo, refreshed by the
supervision sweep) and client-side (`kdt slo --fleet` over several
daemons' ObserveSLO answers).
"""

from __future__ import annotations

import numpy as np

from kubedtn_tpu_torch import telemetry as tele
from kubedtn_tpu_torch.slo.evaluator import evaluate_tenant
from kubedtn_tpu_torch.slo.spec import SloSpec, severity_of


def merge_hists(hists) -> np.ndarray:
    """Exact merge of ladder histograms: elementwise sum (the shared
    reference ladder is what makes this exact — same edges, same bin
    semantics, on every plane)."""
    out = np.zeros(tele.N_BINS, np.float64)
    for h in hists:
        a = np.asarray(h, np.float64)
        out[:a.shape[0]] += a[:tele.N_BINS]
    return out


def contribution(plane: str, tx: float, delivered: float, hist,
                 window_seconds: float, dropped_loss: float = 0.0,
                 dropped_queue: float = 0.0, frozen: bool = False,
                 fast_burn: float = 0.0, parked: float = 0.0,
                 qos: str | None = None,
                 spec: dict | None = None) -> dict:
    """One plane's share of a tenant's fleet view (live or frozen)."""
    return {
        "plane": plane, "frozen": bool(frozen),
        "tx": float(tx), "delivered": float(delivered),
        "dropped_loss": float(dropped_loss),
        "dropped_queue": float(dropped_queue),
        "hist": [float(x) for x in hist],
        "window_seconds": float(window_seconds),
        "fast_burn": float(fast_burn), "parked": float(parked),
        "qos": qos, "spec": spec,
    }


def from_verdict(plane: str, v: dict) -> dict:
    """A live plane's contribution from an SloVerdict dict (the
    evaluator's `verdict_payloads` / the wire's SloTenant row)."""
    return contribution(
        plane, v.get("tx", 0.0), v.get("delivered", 0.0),
        v.get("hist") or (), v.get("window_seconds", 0.0),
        fast_burn=v.get("fast_burn", 0.0),
        parked=v.get("throttle_backlog", 0.0),
        qos=v.get("qos"), spec=v.get("spec"))


def from_frozen_window(plane: str, win: dict,
                       qos: str | None = None) -> dict | None:
    """A frozen contribution from a migration record's reconcile
    `window_src` slice (None when the record predates the hist field
    — old journals merge what they can, which is nothing)."""
    if not win or not win.get("hist"):
        return None
    return contribution(
        plane, win.get("tx", 0.0), win.get("delivered", 0.0),
        win["hist"], win.get("window_seconds", 0.0),
        dropped_loss=win.get("dropped_loss", 0.0),
        dropped_queue=win.get("dropped_queue", 0.0),
        frozen=True, qos=qos)


def _row_of(c: dict) -> np.ndarray:
    """Rebuild the KCOLS window row a contribution describes (only the
    columns the verdict arithmetic reads)."""
    row = np.zeros(tele.KCOLS, np.float64)
    row[tele.T_TX] = c["tx"]
    row[tele.T_DELIVERED] = c["delivered"]
    row[tele.T_DROP_LOSS] = c["dropped_loss"]
    row[tele.T_DROP_QUEUE] = c["dropped_queue"]
    h = np.asarray(c["hist"], np.float64)
    row[tele.T_HIST0:tele.T_HIST0 + min(h.shape[0], tele.N_BINS)] = \
        h[:tele.N_BINS]
    return row


def merge_tenant(tenant: str, contribs: list[dict],
                 spec: SloSpec | None = None,
                 qos: str = "gold") -> dict:
    """One tenant's fleet verdict from its per-plane contributions.

    Slow-window metrics (attainment, estimated tails, slow burn,
    budget) are computed over the SUMMED rows by the same
    `evaluate_tenant` arithmetic a single plane runs — the merged view
    IS a single-plane view of the pooled observation. The fast burn is
    the max over LIVE contributions (a tenant serves on one plane at a
    time; frozen slices are history and carry no fast window), and
    severity re-applies the two-window rule on the merged pair."""
    live = [c for c in contribs if not c["frozen"]]
    frozen = [c for c in contribs if c["frozen"]]
    # spec AND qos both prefer the LIVE (serving) planes, first-wins;
    # frozen slices are history — a pre-move qos/spec must not
    # override the objectives the tenant serves under NOW
    qos_pick = None
    for c in live + frozen:
        if spec is None and c.get("spec"):
            spec = SloSpec.from_dict(c["spec"])
        if qos_pick is None and c.get("qos"):
            qos_pick = c["qos"]
    qos = qos_pick or qos
    if spec is None:
        spec = SloSpec.for_qos(qos)
    rows = [_row_of(c) for c in contribs]
    merged = np.sum(rows, axis=0) if rows else np.zeros(tele.KCOLS)
    seconds = sum(c["window_seconds"] for c in contribs)
    parked = sum(c["parked"] for c in live)
    v = evaluate_tenant(tenant, qos, spec, merged, seconds,
                        np.zeros(tele.KCOLS), parked=parked)
    fast = max((c["fast_burn"] for c in live), default=0.0)
    v.fast_burn = fast
    v.severity = severity_of(spec, fast, v.slow_burn)
    out = v.to_dict()
    out["fleet"] = True
    out["planes"] = sorted({c["plane"] for c in live})
    out["frozen_planes"] = sorted({c["plane"] for c in frozen})
    out["frozen_tx"] = sum(c["tx"] for c in frozen)
    out["frozen_delivered"] = sum(c["delivered"] for c in frozen)
    return out


def fleet_slo(per_plane: dict, frozen: list | None = None,
              tenant: str = "") -> dict:
    """Merge per-plane verdict payloads into fleet verdicts.

    `per_plane` maps plane name → list of SloVerdict dicts (that
    plane's latest evaluation); `frozen` is a list of
    (src_plane, tenant, window_src_dict, qos) migration-journal
    slices. Returns {tenant: fleet verdict dict}, optionally filtered
    to one tenant. O(planes·tenants) — one pass over the payloads,
    one merge per tenant."""
    by_tenant: dict[str, list[dict]] = {}
    for plane, verdicts in sorted((per_plane or {}).items()):
        for v in verdicts:
            name = v.get("tenant", "")
            if tenant and name != tenant:
                continue
            by_tenant.setdefault(name, []).append(
                from_verdict(plane, v))
    for plane, name, win, qos in (frozen or ()):
        if tenant and name != tenant:
            continue
        c = from_frozen_window(plane, win, qos=qos)
        if c is not None:
            by_tenant.setdefault(name, []).append(c)
    return {name: merge_tenant(name, contribs)
            for name, contribs in sorted(by_tenant.items())}
