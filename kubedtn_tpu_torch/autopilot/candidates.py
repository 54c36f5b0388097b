"""Candidate generation — the autopilot's gradient-free search grid.

Port of kubedtn_tpu/autopilot/candidates.py (unchanged).

A paging burn verdict names the symptom (delivery or latency burn over
budget) but not the remedy; the grid enumerates every remediation the
control plane can actually actuate, expressed in the twin's
`Perturbation` vocabulary so the WHOLE grid scores as one batched
sweep (kubedtn_tpu_torch.autopilot.search):

- "shape":   latency / loss / rate deltas on the tenant's own edges —
             each candidate carries the full target `LinkProperties`
             per uid, which is simultaneously the twin's degrade spec
             AND the staged plan's edit list (one vocabulary, no
             translation step between scoring and actuation).
- "reroute": fail the worst (lossiest) edge — the next-hop-alternative
             move: demand shifts to the remaining pairs.
- "quota":   trim the tenant's admission budget (offered-load scale
             < 1); the shed demand is honestly charged back as parked
             backlog when the candidate is scored.
- "drain":   boost the tenant's QoS drain weight one class — a no-op
             in the tenant-scoped fork (no contention there), so its
             projected effect is exactly the parked backlog draining.

Determinism is the headline contract: the grid is a pure function of
(verdict, edge properties, seed). The fixed rungs always appear in a
stable order; the seeded exploration block draws extra shape variants
from a fixed lattice WITHOUT replacement via `np.random.default_rng`
(same seed + same verdict => byte-identical grid, pinned by test).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from kubedtn_tpu_torch.api import parse_duration_us, parse_rate_bps
from kubedtn_tpu_torch.api.types import LinkProperties
from kubedtn_tpu_torch.twin import Perturbation, Scenario

# parked-backlog projection modes (search.py charges these when it
# scores a candidate's replica against the tenant's SloSpec)
PARKED_KEEP = "keep"        # backlog unchanged (shape / reroute)
PARKED_ADD_SHED = "add_shed"  # trimmed demand parks (quota)
PARKED_CLEAR = "clear"      # backlog drains (drain-weight boost)

# the exploration lattice the seeded block samples from: latency scale
# x rate scale (loss is always cleared in explored shapes — loss is
# never a remedy)
LAT_SCALES = (1.0, 0.75, 0.5, 0.25)
RATE_SCALES = (1.0, 1.5, 2.0, 4.0)

QOS_PROMOTION = {"bronze": "silver", "silver": "gold"}


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the search grid: a twin scenario plus the
    actuation recipe (shape edits / fail set / quota factor) and the
    parked-backlog projection used when scoring it."""

    name: str
    kind: str                         # shape | reroute | quota | drain
    # shape: ((uid, LinkProperties), ...) — target properties per edge
    props_by_uid: tuple = ()
    fail_uids: tuple = ()             # reroute: edges to fail
    factor: float = 1.0               # quota/drain offered-load scale
    parked_mode: str = PARKED_KEEP
    cost: int = 0                     # invasiveness ordinal (tiebreak)

    def scenario(self) -> Scenario:
        """The candidate as one sweep replica."""
        perts = [Perturbation("degrade", uid=u, props=p)
                 for u, p in self.props_by_uid]
        perts += [Perturbation("fail", uid=u) for u in self.fail_uids]
        if self.factor != 1.0:
            perts.append(Perturbation("scale", factor=self.factor))
        return Scenario(self.name, tuple(perts))


def _scaled_props(props: LinkProperties, lat_scale: float,
                  rate_scale: float, clear_loss: bool) -> LinkProperties:
    """Transform one edge's properties: loss cleared, latency and rate
    rescaled through the canonical string encodings (parse → scale →
    re-encode in base units, so the result round-trips exactly)."""
    kw = {}
    if clear_loss and (props.loss or props.loss_corr):
        kw["loss"] = ""
        kw["loss_corr"] = ""
    if lat_scale != 1.0 and props.latency:
        us = parse_duration_us(props.latency)
        kw["latency"] = f"{max(0, int(us * lat_scale))}us"
    if rate_scale != 1.0 and props.rate:
        bps = parse_rate_bps(props.rate)
        kw["rate"] = f"{max(1, int(bps * rate_scale))}bps"
    if not kw:
        return props
    return dataclasses.replace(props, **kw)


def _shape(name: str, edge_props: dict, lat_scale: float,
           rate_scale: float, cost: int) -> Candidate | None:
    """A shape candidate over every tenant edge, or None when the
    transform is a no-op on all of them (nothing to stage)."""
    edits = []
    for uid in sorted(edge_props):
        new = _scaled_props(edge_props[uid], lat_scale, rate_scale,
                            clear_loss=True)
        if new != edge_props[uid]:
            edits.append((uid, new))
    if not edits:
        return None
    return Candidate(name=name, kind="shape",
                     props_by_uid=tuple(edits), cost=cost)


def _loss_of(props: LinkProperties) -> float:
    try:
        return float(props.loss) if props.loss else 0.0
    except ValueError:
        return 0.0


def candidate_grid(verdict, edge_props: dict, *, seed: int = 0,
                   width: int = 4) -> list:
    """The deterministic search grid for one paging tenant.

    `edge_props` maps the tenant's ACTIVE link uids to their current
    `LinkProperties` (the controller builds it from the tenant's own
    topologies, restricted to uids live in the snapshot fork — the
    twin compiler rejects edits against inactive rows). `width` sizes
    the seeded exploration block; the fixed remediation rungs are
    always present. O(grid x edges), never O(capacity).
    """
    grid: list = []
    seen: set = set()

    def add(c: Candidate | None) -> None:
        if c is None:
            return
        # dedup by the EDIT, not the name: with no rate configured a
        # rate-scaling rung degenerates to its loss-only sibling — one
        # replica per distinct delta keeps the sweep honest-sized
        sig = (c.kind, c.props_by_uid, c.fail_uids, c.factor,
               c.parked_mode)
        if sig in seen:
            return
        seen.add(sig)
        grid.append(c)

    # fixed rungs, cheapest first: clear loss; clear loss + halve
    # latency; clear loss + double rate
    add(_shape("shape:loss0", edge_props, 1.0, 1.0, cost=1))
    add(_shape("shape:lat50", edge_props, 0.5, 1.0, cost=2))
    add(_shape("shape:rate2x", edge_props, 1.0, 2.0, cost=2))

    # reroute: fail the lossiest edge (only meaningful when the tenant
    # keeps at least one other pair to carry the demand)
    if len(edge_props) > 1:
        worst = max(sorted(edge_props),
                    key=lambda u: (_loss_of(edge_props[u]), u))
        if _loss_of(edge_props[worst]) > 0.0:
            add(Candidate(name=f"reroute:fail-{worst}", kind="reroute",
                          fail_uids=(worst,), cost=3))

    # admission quota trims: shed demand parks (charged at scoring)
    add(Candidate(name="quota:trim75", kind="quota", factor=0.75,
                  parked_mode=PARKED_ADD_SHED, cost=2))
    add(Candidate(name="quota:trim50", kind="quota", factor=0.5,
                  parked_mode=PARKED_ADD_SHED, cost=3))

    # drain-weight boost: only a remedy when admission pressure is
    # part of the burn (a parked backlog to drain)
    if float(getattr(verdict, "throttle_backlog", 0.0)) > 0.0:
        add(Candidate(name="drain:boost", kind="drain",
                      parked_mode=PARKED_CLEAR, cost=2))

    # seeded exploration block: `width` extra shape variants drawn
    # without replacement from the fixed lattice — the gradient-free
    # search the tentpole names, still a pure function of the seed
    lattice = [(ls, rs) for ls in LAT_SCALES for rs in RATE_SCALES
               if (ls, rs) != (1.0, 1.0)]
    rng = np.random.default_rng(int(seed) & 0xFFFFFFFF)
    picks = rng.permutation(len(lattice))[:max(0, int(width))]
    for i in picks:
        ls, rs = lattice[int(i)]
        add(_shape(f"shape:explore-l{int(ls * 100)}-r{int(rs * 100)}",
                   edge_props, ls, rs, cost=4))
    return grid
